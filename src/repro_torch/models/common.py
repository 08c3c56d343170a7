"""Shared building blocks: RMSNorm (plain and gated), the activations, RoPE,
the gated MLP, vocab padding, per-row gathers and scatters.

Plain PyTorch functions with the reference's numerics: f32 statistics in
the norm, f32 rotation angles in RoPE, results cast back to the input dtype.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig


def round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def padded_vocab(cfg: ModelConfig) -> int:
    """Vocab padded to a multiple of 256, always past ``vocab_size``: the
    [mask] id is ``vocab_size``, so it needs a row of its own.  (The
    reference rounds ``vocab_size`` itself; where that is already a multiple
    of 256, as for LLaDA-8B and Dream-7B at full size, it has no [mask] row
    and embeds [mask] as NaN.  Both round alike for the reduced configs.)"""
    return round_up(cfg.vocab_size + 1, 256)


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)


def gated_rms_norm(x: torch.Tensor, gate: torch.Tensor, scale: torch.Tensor,
                   eps: float) -> torch.Tensor:
    """Mamba-2 output norm: ``rms_norm(x * silu(gate))``, the gate's silu in f32."""
    return rms_norm(x * F.silu(gate.float()).to(x.dtype), scale, eps)


def activation(name: str):
    """The FFN activation: ``silu``, or ``gelu`` in its tanh form (the
    reference's ``jax.nn.gelu(x, approximate=True)``)."""
    if name == "silu":
        return F.silu
    if name == "gelu":
        return lambda x: F.gelu(x, approximate="tanh")
    raise ValueError(f"unknown activation {name}")


def rope_tables(
    positions: torch.Tensor,  # [B, K] int
    head_dim: int,
    *,
    theta: float,
    fraction: float = 1.0,
) -> tuple[torch.Tensor, torch.Tensor] | None:
    """``(cos, sin)`` ``[B, K, 1, half]`` f32 of the rotary angles, or None when
    nothing rotates.  Every layer of a segment shares them, so the stack
    computes them once per ``run_layers`` call."""
    rot = int(head_dim * fraction)
    rot -= rot % 2
    if rot == 0:
        return None
    half = rot // 2
    inv_freq = 1.0 / (theta ** (torch.arange(half, dtype=torch.float32,
                                             device=positions.device) / half))
    angles = positions.float()[..., None] * inv_freq              # [B, K, half]
    return torch.cos(angles)[:, :, None, :], torch.sin(angles)[:, :, None, :]


def rotate(x: torch.Tensor, tables) -> torch.Tensor:
    """Half-split (NeoX) rotation of ``x [B, K, H, Dh]`` by :func:`rope_tables`."""
    if tables is None:
        return x
    cos, sin = tables
    half = cos.shape[-1]
    x1 = x[..., :half].float()
    x2 = x[..., half:2 * half].float()
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1).to(x.dtype)
    if 2 * half == x.shape[-1]:
        return out
    return torch.cat([out, x[..., 2 * half:]], dim=-1)


def apply_rope(
    x: torch.Tensor,          # [B, K, H, Dh]
    positions: torch.Tensor,  # [B, K] int
    *,
    theta: float,
    fraction: float = 1.0,
) -> torch.Tensor:
    """Half-split (NeoX) rotary embedding on the first ``fraction`` of Dh."""
    return rotate(x, rope_tables(positions, x.shape[-1], theta=theta, fraction=fraction))


def mlp_apply(params, x: torch.Tensor, act_name: str) -> torch.Tensor:
    """The gated MLP, SwiGLU or GeGLU: ``(act(x @ w_gate) * (x @ w_up)) @ w_down``."""
    return (activation(act_name)(x @ params.w_gate) * (x @ params.w_up)) @ params.w_down


def row_gather(buf: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """buf[b, idx[b, k]] for [B, N] or [B, N, d] buffers."""
    idx = idx.long()
    if buf.dim() == 2:
        return torch.gather(buf, 1, idx)
    return torch.gather(buf, 1, idx[..., None].expand(-1, -1, buf.shape[-1]))


def row_scatter(buf: torch.Tensor, new: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Out of place: a copy of ``buf`` with ``buf[b, idx[b, k]] = new[b, k]``."""
    idx = idx.long()
    if buf.dim() == 3:
        idx = idx[..., None].expand(-1, -1, buf.shape[-1])
    return buf.scatter(1, idx, new.to(buf.dtype))
