"""Reference parameter tree (as numpy arrays) -> the port's parameters.

The reference stores ``embed [Vp, d]``, ``final_norm [d]``, ``lm_head [d, Vp]``
(absent with tied embeddings) and the layers stacked over groups under
``layers["0"]``: ``ln1``, ``attn{wq, wk, wv, wo[, bq, bk, bv]}``, ``ln2`` and
``ffn{w_gate, w_up, w_down}`` (an MoE layer's ``ffn{router, w_gate, w_up,
w_down}``, the experts stacked on the axis after ``[G]``), or for an SSM
stack ``ln1`` and
``mixer{z_proj, x_proj, bc_proj, dt_proj, conv_*, a_log, dt_bias, d_skip,
norm_scale, out_proj}``, each with a leading ``[G]`` axis and laid out for
``x @ W``.  The port keeps that layout per layer, so conversion is an
unstacking; no weight is transposed.
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models.model import DTYPES

# the mixer's per-head parameters and the MoE router are f32 whatever the
# parameter dtype
F32_LEAVES = dict.fromkeys(("a_log", "dt_bias", "d_skip", "router"), torch.float32)


def params_from_numpy(tree: Mapping, cfg: ModelConfig,
                      device: str | torch.device | None = None) -> dict[str, torch.Tensor]:
    """Returns a state dict for ``Model(cfg)``: ``model.load_state_dict(...)``.
    Arrays are cast to ``cfg.param_dtype``, but the f32 leaves."""
    dev = resolve_device(device)
    dtype = DTYPES[cfg.param_dtype]
    if set(tree["layers"]) != {"0"}:
        raise NotImplementedError("params_from_numpy: period-1 stacks only")

    def t(a, dt=dtype) -> torch.Tensor:
        return torch.tensor(np.asarray(a, np.float32), device=dev).to(dt)

    out = {"embed": t(tree["embed"]), "final_norm": t(tree["final_norm"])}
    if not cfg.tie_embeddings:
        out["lm_head"] = t(tree["lm_head"])
    stack = tree["layers"]["0"]
    for g in range(cfg.n_layers):
        out[f"layers.{g}.ln1"] = t(stack["ln1"][g])
        if "mixer" in stack:
            for name, a in stack["mixer"].items():
                out[f"layers.{g}.mixer.{name}"] = t(a[g], F32_LEAVES.get(name, dtype))
            continue
        out[f"layers.{g}.ln2"] = t(stack["ln2"][g])
        for name, a in stack["attn"].items():
            out[f"layers.{g}.attn.{name}"] = t(a[g])
        for name, a in stack["ffn"].items():
            out[f"layers.{g}.ffn.{name}"] = t(a[g], F32_LEAVES.get(name, dtype))
    return out
