"""Reference parameter tree (as numpy arrays) <-> the port's parameters.

The reference stores ``embed [Vp, d]``, ``final_norm [d]``, ``lm_head [d, Vp]``
(absent with tied embeddings) and the layers stacked over groups: pattern
position j of a period-P stack under ``layers[str(j)]``, each leaf with a
leading ``[G]`` axis (``G = n_layers / P``), holding ``ln1`` and
``attn{wq, wk, wv, wo[, bq, bk, bv]}`` or ``mixer{z_proj, x_proj, bc_proj,
dt_proj, conv_*, a_log, dt_bias, d_skip, norm_scale, out_proj}``, and, but on
a pure SSM stack, ``ln2`` and ``ffn{w_gate, w_up, w_down}`` (an MoE layer's
``ffn{router, w_gate, w_up, w_down}``, the experts stacked on the axis after
``[G]``), all laid out for ``x @ W``.  A cross layer holds ``lnx``,
``xattn{wq, wk, wv, wo}`` and the f32 scalar ``gate_attn`` in place of
``ln1``/``attn``.  Leaf ``[g]`` of position j is the port's layer ``g*P +
j``; the port keeps the layout per layer, so conversion is an unstacking
and no weight is transposed.  The encoder (SeamlessM4T) is stacked over its
layers the same way under ``encoder`` (``ln1``, ``attn``, ``ln2``, ``ffn``,
and ``final_norm`` unstacked), and the vision model's ``enc_proj [d_enc,
d_model]`` is a leaf of its own.  :func:`params_to_numpy` restacks the
port's parameters (or their gradients) into that tree, so a port checkpoint
has the reference's layout and its leaves its paths.
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models.model import DTYPES
from repro_torch.sharding import specs

# the mixer's per-head parameters, the MoE router and the cross layers' gate
# are f32 whatever the parameter dtype
F32_LEAVES = dict.fromkeys(("a_log", "dt_bias", "d_skip", "router", "gate_attn"),
                           torch.float32)


def params_from_numpy(tree: Mapping, cfg: ModelConfig,
                      device: str | torch.device | None = None, *,
                      mesh=None, mode: str = "serve") -> dict[str, torch.Tensor]:
    """Returns a state dict for ``Model(cfg)``: ``model.load_state_dict(...)``.
    Arrays are cast to ``cfg.param_dtype``, but the f32 leaves.  With
    ``mesh`` (a DeviceMesh with a ``model`` axis), each leaf is cut to this
    rank's shard (``sharding/specs.py``'s rules of ``mode``: the train mode
    cuts over ``data`` too) before it is copied to the device: the state
    dict of ``Model(cfg, mesh=mesh, mode=mode)``."""
    dev = resolve_device(device)
    sizes = coords = None
    if mesh is not None:
        axes = ("model", "data") if mode == "train" else ("model",)
        all_sizes, all_coords = specs.axis_sizes(mesh), specs.mesh_coords(mesh)
        sizes = {a: all_sizes.get(a, 1) for a in axes}
        coords = {a: all_coords.get(a, 0) for a in axes}
    dtype = DTYPES[cfg.param_dtype]
    period = cfg.pattern_period
    if set(tree["layers"]) != {str(j) for j in range(period)}:
        raise ValueError(f"params_from_numpy: layers {sorted(tree['layers'])} for a period "
                         f"of {period}")

    def t(a, dt=dtype, name: str = "") -> torch.Tensor:
        a = np.asarray(a, np.float32)
        if sizes is not None:
            spec = specs.port_param_spec(name, a.shape, sizes, cfg.head_dim, mode=mode,
                                         ssm=cfg.ssm)
            a = specs.local_slice(a, spec, sizes, coords).copy()
        return torch.tensor(a, device=dev).to(dt)

    out = {"embed": t(tree["embed"], name="embed"), "final_norm": t(tree["final_norm"])}
    if not cfg.tie_embeddings:
        out["lm_head"] = t(tree["lm_head"], name="lm_head")
    if "enc_proj" in tree:
        out["enc_proj"] = t(tree["enc_proj"])

    def unstack(stack, prefixes) -> None:
        """Leaf ``[i]`` of each stacked leaf goes under ``prefixes[i]``."""
        for i, pre in enumerate(prefixes):
            for name in ("ln1", "ln2", "lnx", "gate_attn"):
                if name in stack:
                    out[f"{pre}.{name}"] = t(stack[name][i], F32_LEAVES.get(name, dtype))
            for part in ("attn", "xattn", "mixer", "ffn"):
                for name, a in stack.get(part, {}).items():
                    key = f"{pre}.{part}.{name}"
                    out[key] = t(a[i], F32_LEAVES.get(name, dtype), key)
    for j in range(period):
        unstack(tree["layers"][str(j)],
                [f"layers.{g * period + j}" for g in range(cfg.n_layers // period)])
    if "encoder" in tree:
        unstack(tree["encoder"], [f"encoder.layers.{i}" for i in range(cfg.n_encoder_layers)])
        out["encoder.final_norm"] = t(tree["encoder"]["final_norm"])
    return out


def params_to_numpy(model, *, grads: bool = False) -> dict:
    """The inverse of :func:`params_from_numpy`: the reference's nested tree
    of numpy arrays, layer ``g*P + j`` restacked as ``layers[str(j)][g]``
    and the encoder's layers as ``encoder[...][i]``.  The f32 leaves
    (``F32_LEAVES``) and float32 parameters stay float32; bfloat16 ones are
    widened to float32, which numpy holds and which converts back exactly.
    With ``grads``, the parameters' ``.grad`` (zeros where None) in the same
    tree, under the same paths.  On a model with a mesh every rank gathers
    the whole tree (``FSDP.full``: a collective, so every rank calls it)."""
    def a(name: str) -> np.ndarray:
        p = model.get_parameter(name)
        if grads:
            p = torch.zeros_like(p) if p.grad is None else p.grad
        if model.fsdp is not None:
            p = model.fsdp.full(name, p.detach())
        return p.detach().to("cpu", torch.float32).numpy().copy()
    return restack(model, a)


def restack(model, a) -> dict:
    """The reference's nested tree of ``a(name)`` (a numpy array) for each
    parameter ``name`` of ``model``, layer ``g*P + j``'s leaves stacked as
    ``layers[str(j)][g]``, the encoder's as ``encoder[...][i]``."""
    cfg = model.cfg
    period, n_groups = cfg.pattern_period, cfg.n_layers // cfg.pattern_period

    def stack(prefixes) -> dict:
        first = prefixes[0]
        tree: dict = {}
        for name, _ in model.named_parameters():
            if not name.startswith(first + "."):
                continue
            path = name[len(first) + 1:].split(".")
            leaf = np.stack([a(f"{pre}.{name[len(first) + 1:]}") for pre in prefixes])
            node = tree
            for part in path[:-1]:
                node = node.setdefault(part, {})
            node[path[-1]] = leaf
        return tree

    out = {"embed": a("embed"), "final_norm": a("final_norm"),
           "layers": {str(j): stack([f"layers.{g * period + j}" for g in range(n_groups)])
                      for j in range(period)}}
    if model.lm_head is not None:
        out["lm_head"] = a("lm_head")
    if model.enc_proj is not None:
        out["enc_proj"] = a("enc_proj")
    if model.encoder is not None:
        out["encoder"] = stack([f"encoder.layers.{i}" for i in range(cfg.n_encoder_layers)])
        out["encoder"]["final_norm"] = a("encoder.final_norm")
    return out
