"""Training step of the port, the reference's ``repro/train/train_step.py``:
the diffusion loss, its backward pass and an AdamW step on the model's
parameters in place."""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import prng
from repro_torch.models.model import Model
from repro_torch.train.loss import diffusion_loss
from repro_torch.train.optimizer import OptimizerConfig, OptState, adamw_update, init_opt_state


class TrainState(NamedTuple):
    model: Model          # the parameters, updated in place
    opt: OptState
    key: torch.Tensor     # raw threefry key [2] (core/prng.py)


def init_train_state(model: Model, key: torch.Tensor) -> TrainState:
    """Splits ``key`` as the reference does: ``k1`` initialises the model,
    ``k2`` is the state's key.  ``Model.init`` draws torch's numbers from a
    generator seeded with ``k1``'s words, so the values differ from the
    reference's ``model.init(k1)``; parity runs load the reference's
    parameters through ``convert.params_from_numpy`` instead.  Turns the
    model's grads on."""
    k1, k2 = prng.split(key)
    seed = (int(k1[0]) << 32) | int(k1[1])
    model.init(torch.Generator(device=model.device).manual_seed(seed))
    model.requires_grad_(True)
    return TrainState(model, init_opt_state(model), k2.to(model.device))


def make_train_step(model: Model, opt_cfg: OptimizerConfig, *, ce_chunk: int = 256,
                    remat: bool = True):
    """Returns ``train_step(state, batch) -> (state, metrics)``.  ``batch`` is
    ``{tokens [B, L] int32, loss_region [B, L] bool, optional enc_embeds [B,
    E, d_enc]}`` as numpy arrays or tensors; the metrics (``loss``, ``ce``,
    ``aux``, ``mask_frac``, ``lr``, ``grad_norm``) are 0-dim tensors.  A
    tensor-parallel model (``Model(cfg, mesh=...)``) is refused: its sums
    have no backward here, and training under FSDP x TP is queued
    (ROADMAP.md, A8)."""
    if model.tp is not None:
        raise NotImplementedError("make_train_step: tensor-parallel training (FSDP x TP) is "
                                  "queued in ROADMAP.md (A8)")
    model.requires_grad_(True)

    def train_step(state: TrainState, batch) -> tuple[TrainState, dict]:
        key, sub = prng.split(state.key.to(model.device))
        inputs = {k: torch.as_tensor(v, device=model.device) for k, v in batch.items()}
        for p in model.parameters():
            p.grad = None
        with torch.enable_grad():
            loss, metrics = diffusion_loss(
                model, sub, inputs["tokens"], inputs["loss_region"],
                enc_embeds=inputs.get("enc_embeds"), ce_chunk=ce_chunk, remat=remat)
            loss.backward()
        opt, opt_metrics = adamw_update(opt_cfg, model, state.opt)
        metrics = {k: v.detach() for k, v in metrics.items()}
        return TrainState(model, opt, key), dict(metrics, loss=loss.detach(), **opt_metrics)

    return train_step
