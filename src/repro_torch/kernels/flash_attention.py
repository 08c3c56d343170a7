"""Wrappers of the hand-written flash-attention kernel (``csrc/flash_attention.cu``).

``flash_attention`` is the counterpart of the reference's
``flash_attention_kernel`` (a dense cache); ``paged_flash_attention`` of its
``paged_flash_attention_kernel`` (a page pool read through a block table).
Both launch the same kernel body and take CUDA tensors only; ``ops`` sends
CPU tensors to the plain versions in ``ref``.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 128


def _launch(fn, q, k, v, q_pos, kv_pos, k_strides, v_strides, lkv, bt, page_size, mask):
    """Checks what both modes share, allocates the output, launches and
    counts the launch on ``fn``."""
    name = fn.__name__
    b, hq, lq, d = q.shape
    hkv = k.shape[-2] if bt is not None else k.shape[1]
    for arg, t in (("q", q), ("k", k), ("v", v), ("q_pos", q_pos), ("kv_pos", kv_pos),
                   ("block_tables", q if bt is None else bt)):
        if not t.is_cuda or t.device != q.device:
            raise ValueError(f"{name}: {arg} must be a CUDA tensor on {q.device}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"{name}: q/k/v must share float32 or bfloat16, "
                        f"got {q.dtype}/{k.dtype}/{v.dtype}")
    if hq % hkv or not 0 < d <= MAX_HEAD_DIM:
        raise ValueError(f"{name}: needs Hq % Hkv == 0 and D <= {MAX_HEAD_DIM}")
    if q.stride(-1) != 1 or k.stride(-1) != 1 or v.stride(-1) != 1:
        raise ValueError(f"{name}: the head dimension must be contiguous")
    for arg, t, n in (("q_pos", q_pos, lq), ("kv_pos", kv_pos, lkv)):
        if t.dtype != torch.int32 or t.shape != (b, n) or not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous int32 [{b}, {n}]")
    out = torch.empty((b, lq, hq, d), dtype=q.dtype, device=q.device).transpose(1, 2)
    if lq == 0:
        return out
    strides = (ctypes.c_longlong * 12)(*q.stride()[:3], *k_strides, *v_strides,
                                       *out.stride()[:3])
    status = build.library().repro_flash_attention(
        _DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        q_pos.data_ptr(), kv_pos.data_ptr(), None if bt is None else bt.data_ptr(),
        page_size, ctypes.addressof(strides), b, hq, hkv, lq, lkv, d, 1.0 / math.sqrt(d),
        int(mask.get("window", 0)), int(mask.get("anchor", 0)), int(mask.get("causal", False)),
        int(mask.get("bc_start", 0)), int(mask.get("bc_block", 0)),
        build.stream_ptr(q.device))
    build.check(status, name)
    fn.launches += 1
    return out


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
    b, _, _, d = q.shape
    hkv, lkv = k.shape[1], k.shape[2]
    if q.dim() != 4 or k.shape != (b, hkv, lkv, d) or v.shape != k.shape:
        raise ValueError(f"flash_attention: bad shapes q {tuple(q.shape)} "
                         f"k {tuple(k.shape)} v {tuple(v.shape)}")
    return _launch(flash_attention, q, k, v, q_pos, kv_pos, k.stride()[:3], v.stride()[:3],
                   lkv, None, 0, dict(window=window, anchor=anchor, causal=causal,
                                      bc_start=bc_start, bc_block=bc_block))


flash_attention.launches = 0


def paged_flash_attention(
    q: torch.Tensor,             # [B, Hq, Lq, D]   any strides, last dim contiguous
    k_pool: torch.Tensor,        # [P, ps, Hkv, D]  contiguous, read in place
    v_pool: torch.Tensor,
    q_pos: torch.Tensor,         # [B, Lq] int32
    kv_pos: torch.Tensor,        # [B, n_vp * ps] int32 (-1 = invalid)
    block_tables: torch.Tensor,  # [B, n_vp] int32 page ids, -1 unmapped
) -> torch.Tensor:
    """Attention over a page pool: KV row ``r`` of batch ``b`` is pool row
    ``bt[b, r // ps] * ps + r % ps``; rows of unmapped pages are masked.
    Returns ``[B, Hq, Lq, D]`` in ``q.dtype`` as :func:`flash_attention`."""
    b, _, _, d = q.shape
    ps, hkv = k_pool.shape[1], k_pool.shape[2]
    n_vp = block_tables.shape[-1]
    if (q.dim() != 4 or k_pool.dim() != 4 or k_pool.shape[-1] != d
            or v_pool.shape != k_pool.shape):
        raise ValueError(f"paged_flash_attention: bad shapes q {tuple(q.shape)} "
                         f"pools {tuple(k_pool.shape)} {tuple(v_pool.shape)}")
    if not (k_pool.is_contiguous() and v_pool.is_contiguous()):
        raise ValueError("paged_flash_attention: the pools must be contiguous")
    if (block_tables.dtype != torch.int32 or block_tables.shape != (b, n_vp)
            or not block_tables.is_contiguous()):
        raise ValueError(f"paged_flash_attention: block_tables must be contiguous int32 "
                         f"[{b}, n_vp]")
    # pool strides in the kernel's (b, h, l) slots: b unused, l steps one pool row
    k_strides = (0, k_pool.stride(2), k_pool.stride(1))
    v_strides = (0, v_pool.stride(2), v_pool.stride(1))
    return _launch(paged_flash_attention, q, k_pool, v_pool, q_pos, kv_pos, k_strides,
                   v_strides, n_vp * ps, block_tables, ps, {})


paged_flash_attention.launches = 0
