"""Wrapper of the hand-written flash-attention kernel (``csrc/flash_attention.cu``).

Counterpart of the reference's ``flash_attention_kernel``.  It takes CUDA
tensors only; ``ops.attention`` sends CPU tensors to the plain version
``ref.attention_reference``.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 128


def flash_attention(
    q: torch.Tensor,        # [B, Hq, Lq, D]    any strides, last dim contiguous
    k: torch.Tensor,        # [B, Hkv, Lkv, D]
    v: torch.Tensor,        # [B, Hkv, Lkv, D]
    q_pos: torch.Tensor,    # [B, Lq] int32
    kv_pos: torch.Tensor,   # [B, Lkv] int32 (-1 = invalid)
    *,
    window: int = 0,
    anchor: int = 0,
    causal: bool = False,
    bc_start: int = 0,
    bc_block: int = 0,
) -> torch.Tensor:
    """Returns ``[B, Hq, Lq, D]`` in ``q.dtype``: a transposed view of a
    ``[B, Lq, Hq, D]`` buffer, so the caller's merge of the heads is free."""
    b, hq, lq, d = q.shape
    hkv, lkv = k.shape[1], k.shape[2]
    for name, t in (("q", q), ("k", k), ("v", v), ("q_pos", q_pos), ("kv_pos", kv_pos)):
        if not t.is_cuda or t.device != q.device:
            raise ValueError(f"flash_attention: {name} must be a CUDA tensor on {q.device}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention: q/k/v must share float32 or bfloat16, "
                        f"got {q.dtype}/{k.dtype}/{v.dtype}")
    if q.dim() != 4 or k.shape != (b, hkv, lkv, d) or v.shape != k.shape:
        raise ValueError(f"flash_attention: bad shapes q {tuple(q.shape)} "
                         f"k {tuple(k.shape)} v {tuple(v.shape)}")
    if hq % hkv or not 0 < d <= MAX_HEAD_DIM:
        raise ValueError(f"flash_attention: needs Hq % Hkv == 0 and D <= {MAX_HEAD_DIM}")
    if q.stride(-1) != 1 or k.stride(-1) != 1 or v.stride(-1) != 1:
        raise ValueError("flash_attention: the head dimension must be contiguous")
    for name, t, n in (("q_pos", q_pos, lq), ("kv_pos", kv_pos, lkv)):
        if t.dtype != torch.int32 or t.shape != (b, n) or not t.is_contiguous():
            raise ValueError(f"flash_attention: {name} must be contiguous int32 [{b}, {n}]")
    out = torch.empty((b, lq, hq, d), dtype=q.dtype, device=q.device).transpose(1, 2)
    if lq == 0:
        return out
    strides = (ctypes.c_longlong * 12)(
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3])
    status = build.library().repro_flash_attention(
        _DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        q_pos.data_ptr(), kv_pos.data_ptr(), ctypes.addressof(strides),
        b, hq, hkv, lq, lkv, d, 1.0 / math.sqrt(d), int(window), int(anchor), int(causal),
        int(bc_start), int(bc_block), build.stream_ptr(q.device))
    build.check(status, "flash_attention")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
