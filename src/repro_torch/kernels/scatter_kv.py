"""Wrapper of the hand-written in-place row-scatter kernel (``csrc/scatter_kv.cu``).

Counterpart of the reference's ``scatter_kv_kernel``.  It writes into the
caches it is given (no copy, as the TPU kernel's ``input_output_aliases``)
and takes CUDA tensors only; ``ops.scatter_rows`` sends CPU tensors to the
plain version ``ref.scatter_rows_reference``.
"""
from __future__ import annotations

from typing import Sequence

import torch

from repro_torch.kernels import build


def scatter_rows(
    pairs: Sequence[tuple[torch.Tensor, torch.Tensor]],   # 1 or 2 (cache, new)
    idx: torch.Tensor,                                      # [B, K] int32
) -> None:
    """In place, for each ``(cache [B, S, ...], new [B, K, ...])`` pair:
    ``cache[b, idx[b, k]] = new[b, k]``.  Both pairs (K and V) go in one
    launch and must match in shape and dtype.  ``idx`` must hold distinct
    rows per batch entry, all in ``[0, S)``.  Rows move as 16-byte chunks,
    so a row of ``cache`` must span a multiple of 16 bytes and every tensor
    must start 16-byte aligned; other inputs raise."""
    if not 1 <= len(pairs) <= 2:
        raise ValueError("scatter_rows: one or two (cache, new) pairs")
    cache0, new0 = pairs[0]
    b, s = cache0.shape[:2]
    k = idx.shape[1] if idx.dim() == 2 else -1
    for cache, new in pairs:
        for name, t in (("cache", cache), ("new", new)):
            if not t.is_cuda or t.device != cache0.device:
                raise ValueError(f"scatter_rows: {name} must be a CUDA tensor on {cache0.device}")
            if not t.is_contiguous():
                raise ValueError(f"scatter_rows: {name} must be contiguous")
        if cache.shape != cache0.shape or cache.dtype != cache0.dtype:
            raise ValueError("scatter_rows: the caches must match in shape and dtype")
        if new.dtype != cache.dtype or new.shape != (b, k) + tuple(cache.shape[2:]):
            raise ValueError(f"scatter_rows: new {tuple(new.shape)} {new.dtype} does not "
                             f"fit cache {tuple(cache.shape)} {cache.dtype} and idx [{b}, K]")
    if (idx.dtype != torch.int32 or idx.shape != (b, k) or not idx.is_contiguous()
            or idx.device != cache0.device):
        raise ValueError(f"scatter_rows: idx must be contiguous int32 [{b}, K] on the card")
    if k == 0:
        return
    row_bytes = cache0[0, 0].numel() * cache0.element_size()
    (c1, n1) = pairs[1] if len(pairs) == 2 else (cache0, new0)
    if row_bytes % 16 or any(t.data_ptr() % 16 for pair in pairs for t in pair):
        raise ValueError(f"scatter_rows: rows of {row_bytes} bytes or tensor starts not "
                         "aligned to 16 bytes")
    status = build.library().repro_scatter_rows(
        cache0.data_ptr(), new0.data_ptr(), c1.data_ptr(), n1.data_ptr(), idx.data_ptr(),
        len(pairs), b, s, k, row_bytes, build.stream_ptr(cache0.device))
    build.check(status, "scatter_rows")
    scatter_rows.launches += 1


scatter_rows.launches = 0
