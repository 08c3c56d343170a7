"""Mamba-2 (SSD) mixer layer of the port.

The reference's ``repro.models.mamba``: separate z / x / BC / dt
projections, a depthwise causal conv over x and BC, the chunked SSD scan
(``ops.ssd``, the hand-written chunk kernel on the card), the D skip, the
gated RMSNorm and the output projection.  A decode resumes from a cached
state and conv tail at the block start, so one diffusion iteration replays
only the current block; a prefill also captures that state (``capture_pos``).

Under tensor parallelism (``Model(cfg, mesh=...)``) each rank's ``Mixer``
holds whole SSM heads (``sharding/specs.py``: ``ssm_heads``): its columns of
``z_proj``, ``x_proj``, ``dt_proj`` and ``conv_x``, the matching
``norm_scale``, per-head leaves and rows of ``out_proj``, and the whole
``bc_proj`` and ``conv_bc`` (``ssm_groups``: one group, read by every
head).  The mixer runs at the widths it reads from its weights, and its
state and conv tail hold the rank's heads and x channels
(``ssm_conv_tail``).  Two sums over the ranks: the gated RMSNorm's sum of
squares over ``d_inner`` (``[B, L, 1]``, site ``ssm_norm``) and the output
after ``out_proj`` (``[B, L, d]``, site ``ssm``).  In training three more
values the ranks hold alike sum their gradients where the rank's heads
read them (``sharding/comm.py``'s *f*): the mixer's input to ``z_proj``,
``x_proj`` and ``dt_proj`` (``ssm_in``; ``bc_proj``'s work is the same on
every rank), B and C (``ssm_bc``) and the gated norm's ``1/rms``
(``ssm_rms``).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models.attention import _param
from repro_torch.models.common import gated_rms_norm
from repro_torch.sharding.comm import TPGroup, tp_enter, tp_sum


class SSMState(NamedTuple):
    state: torch.Tensor       # [B, H, N, P] f32: SSD state at the block start
    conv_tail: torch.Tensor   # [B, W-1, conv_ch]: conv inputs just before the block


def mamba_dims(cfg: ModelConfig) -> dict:
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    return dict(d_inner=d_inner, n_heads=d_inner // s.headdim,
                conv_ch=d_inner + 2 * s.n_groups * s.d_state)


class Mixer(nn.Module):
    """The mixer's parameters in the reference's layout (``x @ W``).  The
    per-head ``a_log``, ``dt_bias`` and ``d_skip`` stay f32 whatever the
    parameter dtype, as in the reference."""

    def __init__(self, cfg: ModelConfig, device, dtype):
        super().__init__()
        s, d = cfg.ssm, cfg.d_model
        dims = mamba_dims(cfg)
        d_inner, n_heads = dims["d_inner"], dims["n_heads"]
        d_bc = 2 * s.n_groups * s.d_state
        self.z_proj = _param((d, d_inner), device, dtype)
        self.x_proj = _param((d, d_inner), device, dtype)
        self.bc_proj = _param((d, d_bc), device, dtype)
        self.dt_proj = _param((d, n_heads), device, dtype)
        self.conv_x = _param((s.conv_width, d_inner), device, dtype)
        self.conv_bc = _param((s.conv_width, d_bc), device, dtype)
        self.conv_xb = _param((d_inner,), device, dtype)
        self.conv_bcb = _param((d_bc,), device, dtype)
        self.a_log = _param((n_heads,), device, torch.float32)
        self.dt_bias = _param((n_heads,), device, torch.float32)
        self.d_skip = _param((n_heads,), device, torch.float32)
        self.norm_scale = _param((d_inner,), device, dtype)
        self.out_proj = _param((d_inner, d), device, dtype)


def _causal_conv(xbc: torch.Tensor, tail: torch.Tensor, w: torch.Tensor, b: torch.Tensor):
    """Depthwise causal conv1d over ``xbc [B, L, C]``; ``tail [B, W-1, C]``
    holds the inputs just before the span (zeros at the sequence start).
    The reference's loop over the taps, in its order.  Returns ``(out [B, L,
    C], new tail [B, W-1, C])``."""
    width, length = w.shape[0], xbc.shape[1]
    full = torch.cat([tail.to(xbc.dtype), xbc], dim=1)              # [B, W-1+L, C]
    out = torch.zeros_like(xbc)
    for i in range(width):
        out = out + full[:, i:i + length] * w[i]
    return out + b, full[:, full.shape[1] - (width - 1):]


def mamba_apply(
    mixer: Mixer,
    cfg: ModelConfig,
    x: torch.Tensor,                              # [B, L, d], a contiguous span
    *,
    state: Optional[SSMState] = None,             # resume point (decode); None = sequence start
    capture_pos: Optional[torch.Tensor] = None,   # [B] int: also return the state there
    impl: str = "kernel",                         # ops.ssd's: "plain" is differentiable
    tp: Optional[TPGroup] = None,                 # the ranks the mixer's heads are split over
) -> tuple[torch.Tensor, SSMState, Optional[SSMState]]:
    """Runs the mixer over a span.  Returns ``(y [B, L, d], the state after
    the span, the state at capture_pos or None)``.  The capture re-runs the
    scan with ``dt`` zeroed at positions >= ``capture_pos`` (zero-dt steps are
    exact no-ops), which takes a per-row capture position without slicing,
    and takes the conv tail of the inputs just before it.  With ``tp`` the
    mixer holds a rank's heads, and ``y`` is summed over the ranks."""
    s = cfg.ssm
    # the widths the mixer holds: the config's, or a rank's share of them
    d_inner, n_heads = mixer.x_proj.shape[1], mixer.dt_proj.shape[1]
    g, n = s.n_groups, s.d_state
    b, l, _ = x.shape
    # the rank's heads read x through z/x/dt (their gradients summed over
    # the ranks, ssm_in); bc_proj's work is the same on every rank
    xf = tp_enter(tp, x, "ssm_in")
    z = xf @ mixer.z_proj
    x_in = xf @ mixer.x_proj
    bc_in = x @ mixer.bc_proj
    dt_raw = xf @ mixer.dt_proj
    if state is None:
        tail = torch.zeros((b, s.conv_width - 1, d_inner + bc_in.shape[-1]),
                           dtype=x_in.dtype, device=x.device)
        init = None
    else:
        tail, init = state.conv_tail, state.state
    x_conv, tail_x = _causal_conv(x_in, tail[..., :d_inner], mixer.conv_x, mixer.conv_xb)
    bc_conv, tail_bc = _causal_conv(bc_in, tail[..., d_inner:], mixer.conv_bc, mixer.conv_bcb)
    xs = F.silu(x_conv).reshape(b, l, n_heads, s.headdim)
    bc = tp_enter(tp, F.silu(bc_conv), "ssm_bc")        # B and C, read by the rank's heads
    bmat = bc[..., :g * n].reshape(b, l, g, n)
    cmat = bc[..., g * n:].reshape(b, l, g, n)
    dt = F.softplus(dt_raw.float() + mixer.dt_bias)                  # [B, L, H]

    y, final_state = ops.ssd(xs, dt, mixer.a_log, bmat, cmat, chunk=s.chunk, init_state=init,
                             impl=impl)
    y = y + xs * mixer.d_skip[None, None, :, None]      # f32: d_skip is f32, as in the reference
    y = y.reshape(b, l, d_inner)
    if tp is None:
        y = gated_rms_norm(y, z, mixer.norm_scale, cfg.rms_eps)
    else:
        y = _gated_rms_norm_tp(y, z, mixer.norm_scale, cfg.rms_eps, tp, d_inner * tp.size)
    out = tp_sum(tp, y @ mixer.out_proj.to(y.dtype), "ssm")

    captured = None
    if capture_pos is not None:
        span = torch.arange(l, device=x.device)[None, :, None]
        dt_masked = torch.where(span < capture_pos[:, None, None], dt, 0.0)
        _, cap_state = ops.ssd(xs, dt_masked, mixer.a_log, bmat, cmat, chunk=s.chunk,
                               init_state=init, impl=impl)
        # the conv inputs [capture_pos - W + 1, capture_pos), zeros before the span
        full = torch.cat([tail.to(x_in.dtype), torch.cat([x_in, bc_in], dim=-1)], dim=1)
        cols = capture_pos.long()[:, None] + torch.arange(s.conv_width - 1, device=x.device)
        cap_tail = torch.gather(full, 1, cols[..., None].expand(-1, -1, full.shape[-1]))
        captured = SSMState(cap_state, cap_tail)
    return out, SSMState(final_state, torch.cat([tail_x, tail_bc], dim=-1)), captured


def _gated_rms_norm_tp(x: torch.Tensor, gate: torch.Tensor, scale: torch.Tensor, eps: float,
                       tp: TPGroup, width: int) -> torch.Tensor:
    """``gated_rms_norm`` of a rank's channels of a ``width``-channel row:
    the f32 sums of squares of every rank's channels are summed, then
    divided by the full width (one ``[B, L, 1]`` all-reduce)."""
    xf = (x * F.silu(gate.float()).to(x.dtype)).float()
    var = tp.all_reduce_sum(xf.square().sum(dim=-1, keepdim=True), "ssm_norm") / width
    # 1/rms scales the rank's channels: its gradient sums over the ranks
    return (xf * tp.enter(torch.rsqrt(var + eps), "ssm_rms") * scale.float()).to(x.dtype)


class SSMCache(NamedTuple):
    """The SSM stack's caches, stacked ``[G, ...]`` over the layers
    (``Model.init_cache``), each row a slot: the SSD state and conv tail at
    the current block start (``SSMState``'s fields) and ``ssmh``, the block
    rows a decode rebuilds the contiguous block from (the reference's
    dense-rejoin buffer)."""
    state: torch.Tensor       # [G, B, H, N, P] f32
    conv_tail: torch.Tensor   # [G, B, W-1, conv_ch]
    ssmh: torch.Tensor        # [G, B, Lb, d]
