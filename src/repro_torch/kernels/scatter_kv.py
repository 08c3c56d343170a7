"""Wrappers of the hand-written in-place row-scatter and page-fork kernels
(``csrc/scatter_kv.cu``).

``scatter_rows`` is the counterpart of the reference's ``scatter_kv_kernel``
(a dense cache), ``scatter_rows_paged`` of its ``paged_scatter_kv_kernel``
(a page pool through a block table) and ``fork_pages`` of its
``fork_pages_kernel`` (the copy-on-write page copy).  All write into the
tensors they are given (no copy, as the TPU kernels' ``input_output_aliases``),
launch one kernel for K and V, and take CUDA tensors only; ``ops`` sends CPU
tensors to the plain versions in ``ref``.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.kernels import build


def _launch(fn, pairs, idx, keep, bt, s, num_pages, page_size):
    """Checks what both modes share, launches and counts the launch on
    ``fn``.  ``s`` is the number of rows ``idx`` may address per batch entry."""
    name = fn.__name__
    if not 1 <= len(pairs) <= 2:
        raise ValueError(f"{name}: one or two (cache, new) pairs")
    cache0, new0 = pairs[0]
    b = idx.shape[0] if idx.dim() == 2 else -1
    k = idx.shape[1] if idx.dim() == 2 else -1
    row_shape = tuple(new0.shape[2:])
    for cache, new in pairs:
        for arg, t in (("cache", cache), ("new", new)):
            if not t.is_cuda or t.device != cache0.device:
                raise ValueError(f"{name}: {arg} must be a CUDA tensor on {cache0.device}")
            if not t.is_contiguous():
                raise ValueError(f"{name}: {arg} must be contiguous")
        if cache.shape != cache0.shape or cache.dtype != cache0.dtype:
            raise ValueError(f"{name}: the caches must match in shape and dtype")
        if (new.dtype != cache.dtype or new.shape != (b, k) + row_shape
                or tuple(cache.shape[2:]) != row_shape):
            raise ValueError(f"{name}: new {tuple(new.shape)} {new.dtype} does not "
                             f"fit cache {tuple(cache.shape)} {cache.dtype} and idx [B, K]")
    for arg, t, dtype in (("idx", idx, torch.int32), ("keep", keep, torch.bool),
                          ("block_tables", bt, torch.int32)):
        if t is None:
            continue
        if t.dtype != dtype or t.dim() != 2 or t.shape[0] != b or not t.is_contiguous() \
                or t.device != cache0.device:
            raise ValueError(f"{name}: {arg} must be contiguous {dtype} [{b}, ...] on the card")
    if keep is not None and keep.shape != (b, k):
        raise ValueError(f"{name}: keep must be [{b}, {k}]")
    if k == 0:
        return
    row_bytes = new0[0, 0].numel() * new0.element_size()
    (c1, n1) = pairs[1] if len(pairs) == 2 else (cache0, new0)
    if row_bytes % 16 or any(t.data_ptr() % 16 for pair in pairs for t in pair):
        raise ValueError(f"{name}: rows of {row_bytes} bytes or tensor starts not "
                         "aligned to 16 bytes")
    status = build.library().repro_scatter_rows(
        cache0.data_ptr(), new0.data_ptr(), c1.data_ptr(), n1.data_ptr(), idx.data_ptr(),
        None if keep is None else keep.data_ptr(), None if bt is None else bt.data_ptr(),
        len(pairs), b, s, k, num_pages, page_size, row_bytes, build.stream_ptr(cache0.device))
    build.check(status, name)
    fn.launches += 1


def scatter_rows(
    pairs: Sequence[tuple[torch.Tensor, torch.Tensor]],   # 1 or 2 (cache, new)
    idx: torch.Tensor,                                      # [B, K] int32
    keep: Optional[torch.Tensor] = None,                    # [B, K] bool
) -> None:
    """In place, for each ``(cache [B, S, ...], new [B, K, ...])`` pair:
    ``cache[b, idx[b, k]] = new[b, k]`` where ``keep[b, k]`` (all tokens
    without ``keep``).  Both pairs (K and V) go in one launch and must match
    in shape and dtype.  ``idx`` must hold distinct rows per batch entry, all
    in ``[0, S)``.  Rows move as 16-byte chunks, so a row of ``cache`` must
    span a multiple of 16 bytes and every tensor must start 16-byte aligned;
    other inputs raise."""
    cache0 = pairs[0][0]
    if cache0.shape[0] != idx.shape[0]:
        raise ValueError(f"scatter_rows: cache {tuple(cache0.shape)} and idx "
                         f"{tuple(idx.shape)} differ in batch")
    _launch(scatter_rows, pairs, idx, keep, None, cache0.shape[1], 0, 0)


scatter_rows.launches = 0


def scatter_rows_paged(
    pairs: Sequence[tuple[torch.Tensor, torch.Tensor]],   # 1 or 2 (pool, new)
    idx: torch.Tensor,                                      # [B, K] int32 positions
    block_tables: torch.Tensor,                             # [B, n_vp] int32, -1 unmapped
    keep: Optional[torch.Tensor] = None,                    # [B, K] bool
) -> None:
    """In place, for each ``(pool [P, ps, ...], new [B, K, ...])`` pair:
    ``pool[bt[b, i // ps], i % ps] = new[b, k]`` for ``i = idx[b, k]`` where
    ``keep[b, k]``.  A row of an unmapped page (``bt < 0``) lands on the
    garbage page 0.  The same layout rules as :func:`scatter_rows`."""
    pool0 = pairs[0][0]
    ps = pool0.shape[1]
    _launch(scatter_rows_paged, pairs, idx, keep, block_tables,
            block_tables.shape[-1] * ps, pool0.shape[0], ps)


scatter_rows_paged.launches = 0


def check_fork_lists(src, dst, num_pages: int) -> tuple[np.ndarray, np.ndarray]:
    """The fork's contract on its host-side page lists, as int32 arrays:
    equal lengths, every page in ``[0, num_pages)``, and no real destination
    (a pair with ``src != dst``) that is also a source of the same call, so
    the in-place copies cannot race.  Raises ``ValueError`` otherwise."""
    src = np.asarray(src, np.int64).ravel()
    dst = np.asarray(dst, np.int64).ravel()
    if src.shape != dst.shape:
        raise ValueError(f"fork_pages: {src.size} sources but {dst.size} destinations")
    bad = [int(p) for p in np.concatenate([src, dst]) if not 0 <= p < num_pages]
    if bad:
        raise ValueError(f"fork_pages: pages {sorted(set(bad))} outside [0, {num_pages})")
    real = src != dst
    aliased = set(dst[real].tolist()) & set(src.tolist())
    if aliased:
        raise ValueError(f"fork_pages: destination pages {sorted(aliased)} are also sources")
    if len(set(dst[real].tolist())) != int(real.sum()):
        raise ValueError("fork_pages: a destination page appears twice")
    return src.astype(np.int32), dst.astype(np.int32)


def fork_pages(k: torch.Tensor, v: torch.Tensor, src, dst) -> None:
    """In place, for the K and V pools ``[G, P, ps, ...]`` (one shape and
    dtype): ``pool[:, dst[f]] = pool[:, src[f]]``.  ``src`` and ``dst`` are
    host-side page lists (checked by :func:`check_fork_lists`); ``(p, p)``
    pairs write nothing.  One launch copies every pair in every layer group
    of both pools, with 16-byte copies, so a page must span a multiple of 16
    bytes and the pools must start 16-byte aligned."""
    for t in (k, v):
        if not t.is_cuda or t.device != k.device:
            raise ValueError(f"fork_pages: pools must be CUDA tensors on {k.device}")
        if not t.is_contiguous() or t.shape != k.shape or t.dtype != k.dtype:
            raise ValueError("fork_pages: pools must be contiguous and match in shape and dtype")
    if k.dim() < 3:
        raise ValueError(f"fork_pages: a pool is [G, P, ps, ...], got {tuple(k.shape)}")
    g, p = k.shape[:2]
    src, dst = check_fork_lists(src, dst, p)
    if src.size == 0:
        return
    page_bytes = k[0, 0].numel() * k.element_size()
    if page_bytes % 16 or k.data_ptr() % 16 or v.data_ptr() % 16:
        raise ValueError(f"fork_pages: pages of {page_bytes} bytes or pool starts not "
                         "aligned to 16 bytes")
    pairs = torch.from_numpy(np.stack([src, dst])).to(k.device)
    status = build.library().repro_fork_pages(
        k.data_ptr(), v.data_ptr(), pairs[0].data_ptr(), pairs[1].data_ptr(), src.size, g, p,
        page_bytes, build.stream_ptr(k.device))
    build.check(status, "fork_pages")
    fork_pages.launches += 1


fork_pages.launches = 0
