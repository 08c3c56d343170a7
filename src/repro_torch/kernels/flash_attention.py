"""Wrappers of the hand-written flash-attention kernels (``csrc/flash_attention.cu``).

``flash_attention`` is the counterpart of the reference's
``flash_attention_kernel`` (a dense cache); ``paged_flash_attention`` of its
``paged_flash_attention_kernel`` (a page pool read through a block table).
Both take CUDA tensors only; ``ops`` sends CPU tensors to the plain versions
in ``ref``.

Two kernel bodies compute the same function, and :func:`plan` picks one from
the arguments alone, the same way every time (no failure is caught):

* ``"tensor_core"``: bf16 q with bf16 or int8 K/V, head_dim a multiple of
  16 up to 128, or 256 (Gemma-3: Q then stays in shared memory and the K/V
  ring has 2 stages), every q/k/v stride and base a multiple of 16 bytes.  One
  block per (batch, KV head, up to 64 packed (query head, query row) rows,
  KV split); with few rows,
  ``ks`` warps share each 16-row slab of it; a long cache is split and the
  splits are merged inside the launch by the last block to finish.
* ``"cuda_core"``: everything else (f32, other head dims up to 256, strides
  that are not 16-byte multiples), one block per (batch, query head, 8 rows).

int8 K/V (the int8 KV cache) come with their f32 per-(token, head) scales
``k_scale``/``v_scale`` and are read as codes: both bodies dequantize
inside the kernel, so the cache is never widened.

Each wrapper counts its launches (``launches``) and, beside them, the
launches of each body (``tensor_core_launches``, ``cuda_core_launches``),
of int8 K/V (``int8_launches``) and of each set of mask options
(``option_launches``, keyed by ``(window, anchor, causal, bc_start,
bc_block)``).
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import math

import torch

from repro_torch.kernels import build, ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 256
TC_HEAD_DIMS = frozenset((*range(16, 129, 16), 256))   # the tensor-core body's instantiations
TILE = ref.SPLIT_TILE      # KV rows per tile and packed query rows per block (tensor-core body)
# blocks the planner aims for: half a wave.  Measured on the H100 at the
# paths' shapes, more, shorter blocks (more key-split warps or KV splits)
# lose more to their fixed costs than their parallelism wins (PERF.md)
TARGET_BLOCKS = build.WAVE // 2
MAX_SPLITS = 32            # the kernel's limit on splits per (batch, KV head, row tile)
MAX_SPLIT_PAGES = 1024     # block-table entries one split stages in shared memory
# the last block's merge costs more than walking a short split (timed on the
# H100, PERF.md): a split under 8 tiles loses more than its extra blocks win
MIN_SPLIT_TILES = 8

# per device: int32 counters of the split merge, zero between launches
_COUNTERS: dict = {}


@dataclasses.dataclass(frozen=True)
class Plan:
    body: str              # "tensor_core" or "cuda_core"
    n_splits: int = 1      # KV splits per (batch, KV head, row tile) (tensor-core body)
    split_tiles: int = 0   # 64-row KV tiles per split (the last split may hold fewer)
    row_tiles: int = 0     # blocks of 64 / ks packed (query head, query row) rows per KV head
    ks: int = 1            # warps sharing a 16-row slab, each scoring 64 / ks keys a tile


@functools.lru_cache(maxsize=4096)
def plan_splits(n_blocks: int, lkv: int, page_size: int = 0) -> tuple[int, int]:
    """``(n_splits, split_tiles)`` for a grid of ``n_blocks`` blocks per
    split: each split a run of ``split_tiles`` whole 64-row tiles (the last
    one ragged), none empty.  The fewest splits that reach
    ``TARGET_BLOCKS`` blocks, or as many as ``lkv`` allows, with at least
    ``MIN_SPLIT_TILES`` tiles a split and at most ``MAX_SPLITS`` splits.  In
    paged mode a split's pages must fit the kernel's shared page table, which
    may call for more splits (then more than ``MAX_SPLITS`` can come out)."""
    n_tiles = -(-lkv // TILE)
    cap = (MAX_SPLIT_PAGES - 1) * page_size // TILE if page_size else n_tiles
    fewest = max(1, -(-n_tiles // cap))
    top = max(fewest, min(MAX_SPLITS, n_tiles // MIN_SPLIT_TILES))
    want = min(max(-(-TARGET_BLOCKS // n_blocks), fewest), top)

    def tiles_for(s):          # the split length giving exactly s splits, if one does
        t = -(-n_tiles // s)
        return t if -(-n_tiles // t) == s and t <= cap else None
    for s in [*range(want, top + 1), *range(want - 1, 0, -1)]:
        t = tiles_for(s)
        if t is not None:
            return s, t
    return 1, max(n_tiles, 1)


def plan(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, lkv: int, hkv: int,
         page_size: int = 0) -> Plan:
    """The body and split plan a call takes, from its arguments alone.
    ``k``/``v`` are the cache (dense) or the pools (paged, ``page_size > 0``),
    bf16 or int8 codes for the tensor-core body."""
    b, hq, lq, d = q.shape
    if (q.dtype != torch.bfloat16 or d not in TC_HEAD_DIMS
            or not all(build.aligned16(t) for t in (q, k, v))):
        return Plan("cuda_core")
    # key-split warps: enough that no warp of a block is idle, then more
    # while the grid is under TARGET_BLOCKS
    rows = (hq // hkv) * lq                      # packed rows per KV head
    ks = 4 if rows <= 16 else 2 if rows <= 32 else 1
    while ks < 4 and b * hkv * -(-rows * ks // TILE) < TARGET_BLOCKS:
        ks *= 2
    row_tiles = -(-rows * ks // TILE)
    n_splits, split_tiles = plan_splits(b * hkv * row_tiles, lkv, page_size)
    if n_splits > MAX_SPLITS:
        return Plan("cuda_core")
    return Plan("tensor_core", n_splits, split_tiles, row_tiles, ks)


def _counters(device: torch.device, n: int) -> torch.Tensor:
    """At least ``n`` zeroed int32 counters on ``device``, made (and zeroed)
    once; every launch that uses them leaves them at zero."""
    buf = _COUNTERS.get(device)
    if buf is None or buf.numel() < n:
        buf = torch.zeros(max(n, 1024), dtype=torch.int32, device=device)
        _COUNTERS[device] = buf
    return buf


def _launch(fn, q, k, v, q_pos, kv_pos, k_strides, v_strides, lkv, bt, page_size, mask,
            scales=None):
    """Checks what both modes share, allocates the output, launches the body
    that :func:`plan` picks and counts the launch on ``fn``.  ``scales`` is
    None, or ``(k_scale, v_scale, their 6 strides)`` for int8 K/V."""
    name = fn.__name__
    scale_ts = () if scales is None else scales[:2]
    build.refuse_grad(name, q, k, v, *scale_ts)
    b, hq, lq, d = q.shape
    hkv = k.shape[-2] if bt is not None else k.shape[1]
    for arg, t in (("q", q), ("k", k), ("v", v), ("q_pos", q_pos), ("kv_pos", kv_pos),
                   ("block_tables", q if bt is None else bt),
                   *(("scales", t) for t in scale_ts)):
        if not t.is_cuda or t.device != q.device:
            raise ValueError(f"{name}: {arg} must be a CUDA tensor on {q.device}")
    kv_dtype = q.dtype if scales is None else torch.int8
    if q.dtype not in _DTYPES or k.dtype != kv_dtype or v.dtype != kv_dtype:
        raise TypeError(f"{name}: q/k/v must share float32 or bfloat16, or k/v be int8 "
                        f"with scales, got {q.dtype}/{k.dtype}/{v.dtype}")
    if any(t.dtype != torch.float32 for t in scale_ts):
        raise TypeError(f"{name}: int8 scales must be float32")
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
    strides = (ctypes.c_longlong * 18)(*q.stride()[:3], *k_strides, *v_strides,
                                       *out.stride()[:3],
                                       *((0,) * 6 if scales is None else scales[2]))
    options = (int(mask["window"]), int(mask["anchor"]), int(mask["causal"]),
               int(mask["bc_start"]), int(mask["bc_block"]))
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), q_pos.data_ptr(),
            kv_pos.data_ptr(), None if bt is None else bt.data_ptr(),
            *((None, None) if scales is None else (t.data_ptr() for t in scale_ts)), page_size,
            ctypes.addressof(strides), b, hq, hkv, lq, lkv, d, 1.0 / math.sqrt(d), *options)
    p = plan(q, k, v, lkv, hkv, page_size)
    if p.body == "tensor_core":
        part_o = part_ml = counters = None
        if p.n_splits > 1:
            n_work = b * hkv * p.row_tiles
            parts = n_work * p.n_splits * TILE      # a work item's partials have room for 64 rows
            part_o = torch.empty(parts * d, dtype=torch.float32, device=q.device)
            part_ml = torch.empty(parts * 2, dtype=torch.float32, device=q.device)
            counters = _counters(q.device, n_work)
        status = build.library().repro_flash_attention_tc(
            *args, p.ks, p.n_splits, p.split_tiles,
            *(None if t is None else t.data_ptr() for t in (part_o, part_ml, counters)),
            build.stream_ptr(q.device))
        build.check(status, name)
        fn.tensor_core_launches += 1
    else:
        status = build.library().repro_flash_attention(_DTYPES[q.dtype], *args,
                                                       build.stream_ptr(q.device))
        build.check(status, name)
        fn.cuda_core_launches += 1
    fn.launches += 1
    if scales is not None:
        fn.int8_launches += 1
    fn.option_launches[options] = fn.option_launches.get(options, 0) + 1
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
    k_scale: torch.Tensor | None = None,    # [B, Hkv, Lkv] f32: k, v are int8 codes
    v_scale: torch.Tensor | None = None,
) -> torch.Tensor:
    """Returns ``[B, Hq, Lq, D]`` in ``q.dtype``: a transposed view of a
    ``[B, Lq, Hq, D]`` buffer, so the caller's merge of the heads is free.
    With ``k_scale``/``v_scale`` (any strides), ``k``/``v`` are int8 codes."""
    b, _, _, d = q.shape
    hkv, lkv = k.shape[1], k.shape[2]
    if q.dim() != 4 or k.shape != (b, hkv, lkv, d) or v.shape != k.shape:
        raise ValueError(f"flash_attention: bad shapes q {tuple(q.shape)} "
                         f"k {tuple(k.shape)} v {tuple(v.shape)}")
    scales = None
    if k_scale is not None or v_scale is not None:
        if k_scale is None or v_scale is None or any(
                t.shape != (b, hkv, lkv) for t in (k_scale, v_scale)):
            raise ValueError(f"flash_attention: int8 K/V need k_scale and v_scale "
                             f"[{b}, {hkv}, {lkv}]")
        scales = (k_scale, v_scale, (*k_scale.stride(), *v_scale.stride()))
    return _launch(flash_attention, q, k, v, q_pos, kv_pos, k.stride()[:3], v.stride()[:3],
                   lkv, None, 0, dict(window=window, anchor=anchor, causal=causal,
                                      bc_start=bc_start, bc_block=bc_block), scales)


def window_block_tables(block_tables: torch.Tensor, limit: torch.Tensor | None,
                        page_size: int) -> torch.Tensor:
    """The read view of a block table under the sliding window: virtual
    pages that start at or beyond the row's exclusive horizon ``limit [B]``
    become -1, so the kernel's walk skips them (a page that straddles the
    horizon stays mapped; its positions past it are masked through
    ``kv_pos``).  Writes keep the real table.  ``limit=None`` returns the
    table itself."""
    if limit is None:
        return block_tables
    n_vp = block_tables.shape[1]
    starts = torch.arange(0, n_vp * page_size, page_size, dtype=torch.int32,
                          device=block_tables.device)
    return torch.where(starts[None, :] < limit[:, None], block_tables, -1)


def paged_flash_attention(
    q: torch.Tensor,             # [B, Hq, Lq, D]   any strides, last dim contiguous
    k_pool: torch.Tensor,        # [P, ps, Hkv, D]  contiguous, read in place
    v_pool: torch.Tensor,
    q_pos: torch.Tensor,         # [B, Lq] int32
    kv_pos: torch.Tensor,        # [B, n_vp * ps] int32 (-1 = invalid)
    block_tables: torch.Tensor,  # [B, n_vp] int32 page ids, -1 unmapped
    *,
    window: int = 0,
    anchor: int = 0,
    causal: bool = False,
    bc_start: int = 0,
    bc_block: int = 0,
    k_scale: torch.Tensor | None = None,    # [P, ps, Hkv] f32: the pools are int8 codes
    v_scale: torch.Tensor | None = None,
) -> torch.Tensor:
    """Attention over a page pool: KV row ``r`` of batch ``b`` is pool row
    ``bt[b, r // ps] * ps + r % ps``; rows of unmapped pages are masked, and
    the mask options and int8 scales (contiguous scale pools) work as in
    :func:`flash_attention`.  Returns ``[B, Hq, Lq, D]`` in ``q.dtype`` as
    :func:`flash_attention`."""
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
    scales = None
    if k_scale is not None or v_scale is not None:
        if k_scale is None or v_scale is None or any(
                t.shape != k_pool.shape[:3] or not t.is_contiguous() for t in (k_scale, v_scale)):
            raise ValueError(f"paged_flash_attention: int8 pools need contiguous k_scale and "
                             f"v_scale {tuple(k_pool.shape[:3])}")
        scales = (k_scale, v_scale, (0, 1, hkv, 0, 1, hkv))
    return _launch(paged_flash_attention, q, k_pool, v_pool, q_pos, kv_pos, k_strides,
                   v_strides, n_vp * ps, block_tables, ps,
                   dict(window=window, anchor=anchor, causal=causal, bc_start=bc_start,
                        bc_block=bc_block), scales)


for _fn in (flash_attention, paged_flash_attention):
    _fn.launches = _fn.tensor_core_launches = _fn.cuda_core_launches = _fn.int8_launches = 0
    _fn.option_launches = {}
