"""Wrappers of the hand-written in-place row-scatter and page-fork kernels
(``csrc/scatter_kv.cu``).

``scatter_rows`` is the counterpart of the reference's ``scatter_kv_kernel``
(a dense cache), ``scatter_rows_paged`` of its ``paged_scatter_kv_kernel``
(a page pool through a block table) and ``fork_pages`` of its
``fork_pages_kernel`` (the copy-on-write page copy).  All write into the
tensors they are given (no copy, as the TPU kernels' ``input_output_aliases``),
launch one kernel for K and V, and take CUDA tensors only; ``ops`` sends CPU
tensors to the plain versions in ``ref``.  The scatters take the serving
path's ``row_mask`` and ``token_mask`` themselves, so a masked scatter is
one launch; :func:`plan` gives their block shape.

``quantize_scatter_rows`` and ``quantize_scatter_rows_paged`` are the int8
cache's write (the reference's ``_quantize_rows`` and four scatters): one
launch quantizes the new K and V rows per (token, head) and writes their
codes and scales; :func:`quant_plan` gives their block shape.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.kernels import build

MAX_THREADS = 256           # threads of a block (the kernel's launch bound)
LOADS = 4                   # 16-byte loads a thread keeps in flight (the kernel's kLoads)
GRID_LIMIT = 2**31 - 1      # gridDim.x, and the kernel's int piece indices


@dataclasses.dataclass(frozen=True)
class Plan:
    """A scatter's block shape: a row is cut into pieces of ``chunk_bytes``
    (the last piece of a row may be shorter); a group of ``threads //
    rows_per_block`` threads moves one piece, each thread ``LOADS`` 16-byte
    vectors; a block moves ``rows_per_block`` pieces."""
    threads: int
    rows_per_block: int
    chunk_bytes: int

    @property
    def group(self) -> int:
        return self.threads // self.rows_per_block

    def blocks(self, b: int, k: int, pairs: int, row_bytes: int) -> int:
        """The launch's grid: every piece of the ``b * k * pairs`` rows."""
        splits = -(-row_bytes // self.chunk_bytes)
        return -(-(b * k * pairs * splits) // self.rows_per_block)


def _pow2(n: int) -> int:
    return 1 << max(0, n - 1).bit_length()


@functools.lru_cache(maxsize=256)
def plan(b: int, k: int, pairs: int, row_bytes: int) -> Plan:
    """The block shape of a scatter of ``b * k`` tokens' rows of ``row_bytes``
    (a multiple of 16) into ``pairs`` caches: a group of up to
    ``MAX_THREADS`` threads moves a row with ``LOADS`` 16-byte loads a
    thread (a row longer than 16 KB is cut into pieces of 16 KB); pieces
    pack into a block, a power of two of them, as long as the grid keeps a
    wave of blocks (``build.WAVE``: 1 KB rows at prefill sizes).  On the
    H100, 4 loads a thread won or tied at every decode shape timed, and
    cutting the few rows of a decode across more blocks did not pay
    (PERF.md)."""
    if row_bytes <= 0 or row_bytes % 16 or min(b, k, pairs) <= 0:
        raise ValueError(f"scatter plan: no block shape for b={b} k={k} pairs={pairs} "
                         f"row_bytes={row_bytes}")
    group = min(MAX_THREADS, _pow2(-(-(row_bytes // 16) // LOADS)))
    chunk = 16 * LOADS * group
    pieces = b * k * pairs * -(-row_bytes // chunk)
    rows_per_block = _pow2(max(1, min(MAX_THREADS // group, pieces // build.WAVE)) + 1) // 2
    if pieces + rows_per_block > GRID_LIMIT:
        raise ValueError(f"scatter plan: {pieces} row pieces exceed the grid")
    return Plan(group * rows_per_block, rows_per_block, chunk)


def _check_routing(name, card, b, k, idx, bt, row_mask, token_mask) -> None:
    """The scatters' ``idx``, block table and masks: contiguous, on the
    card, of the kernel's dtypes and shapes.  Raises ``ValueError``."""
    for arg, t, want_dtype, want in (("idx", idx, torch.int32, (b, k)),
                                     ("block_tables", bt, torch.int32, None),
                                     ("row_mask", row_mask, torch.bool, (b,)),
                                     ("token_mask", token_mask, torch.bool, (b, k))):
        if t is not None and (
                t.dtype != want_dtype or t.get_device() != card or not t.is_contiguous()
                or (t.shape != want if want else t.dim() != 2 or t.shape[0] != b)):
            raise ValueError(f"{name}: {arg} must be contiguous {want_dtype} "
                             f"{list(want or (b, '...'))} on the card, got "
                             f"{tuple(t.shape)} {t.dtype} on {t.device}")


def _launch(fn, pairs, idx, row_mask, token_mask, bt, s, num_pages, page_size):
    """Checks what both modes share, launches and counts the launch on
    ``fn``.  ``s`` is the number of rows ``idx`` may address per batch entry.
    Each refusal raises ``ValueError``; the checks read each tensor's
    properties once, as the serving path calls this in every layer."""
    name = fn.__name__
    if not 1 <= len(pairs) <= 2:
        raise ValueError(f"{name}: one or two (cache, new) pairs")
    (c0, n0), (c1, n1) = pairs[0], pairs[-1]
    build.refuse_grad(name, c0, n0, c1, n1)
    card = c0.get_device()                      # -1 off the card
    for arg, t in (("cache", c0), ("new", n0), ("cache", c1), ("new", n1)):
        if card < 0 or t.get_device() != card:
            raise ValueError(f"{name}: {arg} must be a CUDA tensor on {c0.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous")
    shape, dtype = c0.shape, c0.dtype
    if c1.shape != shape or c1.dtype != dtype:
        raise ValueError(f"{name}: the caches must match in shape and dtype")
    b, k = idx.shape if idx.dim() == 2 else (-1, -1)
    new_shape = (b, k) + shape[2:]
    if n0.shape != new_shape or n0.dtype != dtype or n1.shape != new_shape or n1.dtype != dtype:
        bad = n0 if n0.shape != new_shape or n0.dtype != dtype else n1
        raise ValueError(f"{name}: new {tuple(bad.shape)} {bad.dtype} does not "
                         f"fit cache {tuple(shape)} {dtype} and idx [B, K]")
    _check_routing(name, card, b, k, idx, bt, row_mask, token_mask)
    if b * k == 0:
        return
    row_bytes = n0.numel() // (b * k) * n0.element_size()
    ptrs = (c0.data_ptr(), n0.data_ptr(), c1.data_ptr(), n1.data_ptr())
    if row_bytes % 16 or (ptrs[0] | ptrs[1] | ptrs[2] | ptrs[3]) % 16:
        raise ValueError(f"{name}: rows of {row_bytes} bytes or tensor starts not "
                         "aligned to 16 bytes")
    pl = plan(b, k, len(pairs), row_bytes)
    status = build.library().repro_scatter_rows(
        *ptrs, idx.data_ptr(), None if row_mask is None else row_mask.data_ptr(),
        None if token_mask is None else token_mask.data_ptr(),
        None if bt is None else bt.data_ptr(), len(pairs), b, s, k, num_pages, page_size,
        row_bytes, pl.threads, pl.rows_per_block, pl.chunk_bytes, build.stream_ptr(c0.device))
    build.check(status, name)
    fn.launches += 1


def scatter_rows(
    pairs: Sequence[tuple[torch.Tensor, torch.Tensor]],   # 1 or 2 (cache, new)
    idx: torch.Tensor,                                      # [B, K] int32
    *,
    row_mask: Optional[torch.Tensor] = None,                # [B] bool
    token_mask: Optional[torch.Tensor] = None,              # [B, K] bool
) -> None:
    """In place, for each ``(cache [B, S, ...], new [B, K, ...])`` pair:
    ``cache[b, idx[b, k]] = new[b, k]`` where ``row_mask[b]`` and
    ``token_mask[b, k]`` pass (every token without masks).  Both pairs (K
    and V) go in one launch and must match in shape and dtype.  ``idx`` must
    hold distinct rows per batch entry, all in ``[0, S)``.  Rows move as
    16-byte chunks, so a row of ``cache`` must span a multiple of 16 bytes
    and every tensor must start 16-byte aligned; other inputs raise.  The
    masks are contiguous bool tensors on the card; nothing is copied."""
    cache0 = pairs[0][0]
    if cache0.shape[0] != idx.shape[0]:
        raise ValueError(f"scatter_rows: cache {tuple(cache0.shape)} and idx "
                         f"{tuple(idx.shape)} differ in batch")
    _launch(scatter_rows, pairs, idx, row_mask, token_mask, None, cache0.shape[1], 0, 0)


scatter_rows.launches = 0


def scatter_rows_paged(
    pairs: Sequence[tuple[torch.Tensor, torch.Tensor]],   # 1 or 2 (pool, new)
    idx: torch.Tensor,                                      # [B, K] int32 positions
    block_tables: torch.Tensor,                             # [B, n_vp] int32, -1 unmapped
    *,
    row_mask: Optional[torch.Tensor] = None,                # [B] bool
    token_mask: Optional[torch.Tensor] = None,              # [B, K] bool
) -> None:
    """In place, for each ``(pool [P, ps, ...], new [B, K, ...])`` pair:
    ``pool[bt[b, i // ps], i % ps] = new[b, k]`` for ``i = idx[b, k]`` where
    the masks pass.  A row of an unmapped page (``bt < 0``) lands on the
    garbage page 0.  The same layout rules as :func:`scatter_rows`."""
    pool0 = pairs[0][0]
    ps = pool0.shape[1]
    _launch(scatter_rows_paged, pairs, idx, row_mask, token_mask, block_tables,
            block_tables.shape[-1] * ps, pool0.shape[0], ps)


scatter_rows_paged.launches = 0


@dataclasses.dataclass(frozen=True)
class QuantPlan:
    """A quantizing scatter's block shape: each item (token, K or V, head)
    is a group of ``group`` threads, each of which holds ``elems``
    consecutive elements of the head's row; a block holds ``per_block``
    items."""
    group: int
    per_block: int
    elems: int = 4

    @property
    def threads(self) -> int:
        return self.group * self.per_block

    def blocks(self, b: int, k: int, hkv: int) -> int:
        return -(-(b * k * 2 * hkv) // self.per_block)


@functools.lru_cache(maxsize=256)
def quant_plan(b: int, k: int, hkv: int, dh: int) -> QuantPlan:
    """The block shape of a quantizing scatter of ``b * k`` tokens of ``hkv``
    heads of ``dh`` elements: 4 a thread up to 128 (a multiple of 4), else 8
    (a multiple of 8, at most 256; the kernel's ``quant_elems``), so that a
    group is at most a warp; a group of the power of two of threads that
    covers ``dh / elems`` (its xor shuffles then stay inside it), and as
    many groups a block, up to ``MAX_THREADS`` threads and at least one warp
    (the shuffles take whole warps), as keep a wave of blocks."""
    elems = 8 if dh > 128 else 4
    if dh <= 0 or dh % elems or dh > 256 or min(b, k, hkv) <= 0:
        raise ValueError(f"quantizing scatter plan: no block shape for b={b} k={k} "
                         f"hkv={hkv} dh={dh}")
    group = _pow2(dh // elems)
    items = b * k * 2 * hkv
    per_block = _pow2(max(1, min(MAX_THREADS // group, items // build.WAVE)) + 1) // 2
    per_block = max(per_block, 32 // group)
    if items + per_block > GRID_LIMIT:
        raise ValueError(f"quantizing scatter plan: {items} items exceed the grid")
    return QuantPlan(group, per_block, elems)


_NEW_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _launch_quant(fn, pairs, idx, row_mask, token_mask, bt, s, num_pages, page_size):
    """Checks and launches a quantizing scatter of ``((codes, scales), new)``
    pairs (K, then V) and counts the launch on ``fn``."""
    name = fn.__name__
    if len(pairs) != 2:
        raise ValueError(f"{name}: the K and the V pair")
    ((kc, ksc), kn), ((vc, vsc), vn) = pairs
    build.refuse_grad(name, kc, ksc, kn, vc, vsc, vn)
    card = kc.get_device()
    for arg, t in (("codes", kc), ("scales", ksc), ("new", kn), ("codes", vc),
                   ("scales", vsc), ("new", vn)):
        if card < 0 or t.get_device() != card:
            raise ValueError(f"{name}: {arg} must be a CUDA tensor on {kc.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous")
    shape = kc.shape
    if (kc.dtype != torch.int8 or vc.dtype != torch.int8 or vc.shape != shape
            or ksc.dtype != torch.float32 or vsc.dtype != torch.float32
            or ksc.shape != shape[:-1] or vsc.shape != shape[:-1]):
        raise ValueError(f"{name}: int8 codes {tuple(shape)} and f32 scales "
                         f"{tuple(shape[:-1])} for K and V")
    b, k = idx.shape if idx.dim() == 2 else (-1, -1)
    hkv, dh = shape[-2], shape[-1]
    for t in (kn, vn):
        if t.shape != (b, k, hkv, dh) or t.dtype not in _NEW_DTYPES or t.dtype != kn.dtype:
            raise ValueError(f"{name}: new {tuple(t.shape)} {t.dtype} does not fit codes "
                             f"{tuple(shape)} and idx [B, K] (bf16 or f32)")
    _check_routing(name, card, b, k, idx, bt, row_mask, token_mask)
    if b * k == 0:
        return
    pl = quant_plan(b, k, hkv, dh)
    status = build.library().repro_quant_scatter_rows(
        kc.data_ptr(), ksc.data_ptr(), kn.data_ptr(), vc.data_ptr(), vsc.data_ptr(),
        vn.data_ptr(), _NEW_DTYPES[kn.dtype], idx.data_ptr(),
        None if row_mask is None else row_mask.data_ptr(),
        None if token_mask is None else token_mask.data_ptr(),
        None if bt is None else bt.data_ptr(), b, s, k, hkv, dh, num_pages, page_size,
        pl.group, pl.per_block, build.stream_ptr(kc.device))
    build.check(status, name)
    fn.launches += 1


def quantize_scatter_rows(
    pairs: Sequence[tuple[tuple[torch.Tensor, torch.Tensor], torch.Tensor]],
    idx: torch.Tensor,                                      # [B, K] int32
    *,
    row_mask: Optional[torch.Tensor] = None,                # [B] bool
    token_mask: Optional[torch.Tensor] = None,              # [B, K] bool
) -> None:
    """In place, for the K and the V pair ``((codes [B, S, Hkv, Dh] int8,
    scales [B, S, Hkv] f32), new [B, K, Hkv, Dh] bf16 or f32)``: the new
    rows quantized per (token, head) as ``ref.quantize_rows`` and written at
    ``idx`` where the masks pass, as :func:`scatter_rows` writes.  One
    launch; Dh a multiple of 4, at most 128."""
    codes = pairs[0][0][0]
    if codes.shape[0] != idx.shape[0]:
        raise ValueError(f"quantize_scatter_rows: codes {tuple(codes.shape)} and idx "
                         f"{tuple(idx.shape)} differ in batch")
    _launch_quant(quantize_scatter_rows, pairs, idx, row_mask, token_mask, None,
                  codes.shape[1], 0, 0)


def quantize_scatter_rows_paged(
    pairs: Sequence[tuple[tuple[torch.Tensor, torch.Tensor], torch.Tensor]],
    idx: torch.Tensor,                                      # [B, K] int32 positions
    block_tables: torch.Tensor,                             # [B, n_vp] int32, -1 unmapped
    *,
    row_mask: Optional[torch.Tensor] = None,
    token_mask: Optional[torch.Tensor] = None,
) -> None:
    """:func:`quantize_scatter_rows` into int8 code pools ``[P, ps, Hkv, Dh]``
    and scale pools ``[P, ps, Hkv]`` through a block table, routed as
    :func:`scatter_rows_paged` routes."""
    codes = pairs[0][0][0]
    ps = codes.shape[1]
    _launch_quant(quantize_scatter_rows_paged, pairs, idx, row_mask, token_mask, block_tables,
                  block_tables.shape[-1] * ps, codes.shape[0], ps)


quantize_scatter_rows.launches = quantize_scatter_rows_paged.launches = 0


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
    bytes and the pools must start 16-byte aligned.  The int8 cache's scale
    pools ``[G, P, ps, Hkv]`` take a launch of their own, counted also in
    ``scale_launches`` (the only 4-dimensional pools)."""
    build.refuse_grad("fork_pages", k, v)
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
    if k.dim() == 4:
        fork_pages.scale_launches += 1


fork_pages.launches = fork_pages.scale_launches = 0
