"""Hand-rolled AdamW with a cosine LR schedule, the reference's
``repro/train/optimizer.py``: moments in f32 whatever the parameter dtype,
global-norm clipping, decoupled weight decay, and the step incremented
before the LR and the bias corrections are taken.

The decay rule is the reference's as it runs, not as its docstring states.
The reference decays a leaf of rank >= 2 and means to skip 1-D ones (norm
scales, biases), but its layer leaves are stacked over the groups, so a
layer's ``ln1 [G, d]`` has rank 2 and is decayed; only the top-level
``final_norm``, the encoder's ``final_norm`` and the cross layers'
``gate_attn [G]`` escape.  The port keeps each layer's leaves unstacked, so
it ranks a leaf as the reference stacks it (:func:`decays`) and decays the
same leaves.  This mirrors a reference-side fault on purpose (ROADMAP.md);
``tests/test_torch_train.py::test_decay_rule_follows_the_stacked_rank``
pins it in both packages.
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch

from repro_torch.utils.tree import global_norm


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    lr: float = 3e-4
    betas: tuple[float, float] = (0.9, 0.95)
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1


class OptState(NamedTuple):
    step: int                       # updates taken
    mu: dict[str, torch.Tensor]     # f32 first moments, by parameter name
    nu: dict[str, torch.Tensor]     # f32 second moments


def init_opt_state(model: torch.nn.Module) -> OptState:
    def zeros():
        return {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                for n, p in model.named_parameters()}
    return OptState(0, zeros(), zeros())


def decays(name: str, p: torch.Tensor) -> bool:
    """Whether the reference decays parameter ``name``: the rank of its leaf
    stacked over the layers (one more for a layer's or an encoder layer's
    parameter) is at least 2."""
    stacked = name.startswith("layers.") or name.startswith("encoder.layers.")
    return p.dim() + int(stacked) >= 2


def lr_at(cfg: OptimizerConfig, step) -> torch.Tensor:
    """The f32 learning rate at ``step``: linear warmup, then cosine decay to
    ``min_lr_ratio * lr`` at ``total_steps``, in the reference's order of
    operations."""
    step = torch.as_tensor(step, dtype=torch.float32)
    warm = cfg.lr * step / max(cfg.warmup_steps, 1)
    frac = torch.clamp((step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1),
                       0, 1)
    cos = cfg.lr * (cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5
                    * (1 + torch.cos(math.pi * frac)))
    return torch.where(step < cfg.warmup_steps, warm, cos)


def clip_scale(gnorm: torch.Tensor, max_norm: float) -> torch.Tensor:
    return torch.clamp(max_norm / (gnorm + 1e-9), max=1.0)


def clip_by_global_norm(grads: dict, max_norm: float) -> tuple[dict, torch.Tensor]:
    """``(grads * min(1, max_norm / (norm + 1e-9)), norm)``, f32."""
    gnorm = global_norm(grads)
    scale = clip_scale(gnorm, max_norm)
    return {k: g.float() * scale for k, g in grads.items()}, gnorm


@torch.no_grad()
def adamw_update(cfg: OptimizerConfig, model: torch.nn.Module, state: OptState
                 ) -> tuple[OptState, dict]:
    """One AdamW step on ``model``'s parameters in place, from their
    ``.grad`` (zeros where None, as ``jax.grad`` gives an unused leaf).
    Returns the new state and ``{"lr", "grad_norm"}`` (the norm before the
    clip).  On a model with a mesh each rank updates its shards, and the
    norm is the whole gradient tree's (``FSDP.grad_norm``)."""
    params = dict(model.named_parameters())
    grads = {n: torch.zeros_like(p) if p.grad is None else p.grad for n, p in params.items()}
    fsdp = getattr(model, "fsdp", None)
    gnorm = global_norm(grads) if fsdp is None else fsdp.grad_norm(grads)
    scale = clip_scale(gnorm, cfg.grad_clip)      # the clip, applied leaf by leaf below
    step = state.step + 1
    b1, b2 = cfg.betas
    lr = lr_at(cfg, step)
    t = torch.tensor(step, dtype=torch.float32)
    bc1, bc2 = 1 - b1 ** t, 1 - b2 ** t
    dev = {}
    for name, p in params.items():
        if p.device not in dev:
            dev[p.device] = tuple(x.to(p.device) for x in (scale, lr, bc1, bc2))
        scale_d, lr_d, bc1_d, bc2_d = dev[p.device]
        g, m, v = grads[name].float() * scale_d, state.mu[name], state.nu[name]
        m.mul_(b1).add_((1 - b1) * g)
        v.mul_(b2).add_((1 - b2) * torch.square(g))
        update = (m / bc1_d) / (torch.sqrt(v / bc2_d) + cfg.eps)
        if decays(name, p):
            update = update + cfg.weight_decay * p.float()
        p.copy_(p.float() - lr_d * update)
    return OptState(step, state.mu, state.nu), {"lr": lr, "grad_norm": gnorm}
