"""The port's kernel entry points.

Each op picks its implementation by where its tensors lie: CUDA tensors go
through the hand-written kernel, CPU tensors through the plain PyTorch
version in ``ref``.  There is no fallback: a failed build or launch raises,
and tensors split across devices raise.  ``attention`` and ``ssd`` also take
``impl``: ``"kernel"`` (the default, the choice by device) or ``"plain"``,
the ``ref`` version on either device, which autograd differentiates (the
training forward's, as the reference trains on its XLA lowerings).  The
kernels have no backward, and each wrapper raises when grad mode is on and
an input requires grad.  On fake tensors (the dry run, ``FakeTensorMode``)
each op returns an empty output of its shape and tallies the kernel's work
(``kernels/fake.py``); it launches nothing.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels import fake, ref
from repro_torch.kernels.flash_attention import (
    flash_attention,
    paged_flash_attention,
    window_block_tables,
)
from repro_torch.kernels.importance import importance, variation
from repro_torch.kernels.scatter_kv import check_fork_lists
from repro_torch.kernels.scatter_kv import fork_pages as fork_pages_kernel
from repro_torch.kernels.scatter_kv import quantize_scatter_rows, quantize_scatter_rows_paged
from repro_torch.kernels.scatter_kv import scatter_rows as scatter_rows_kernel
from repro_torch.kernels.scatter_kv import scatter_rows_paged as scatter_rows_paged_kernel
from repro_torch.kernels.ssd_scan import ssd_chunks as ssd_chunks_kernel


IMPLS = ("kernel", "plain")


def _check_impl(op: str, impl: str) -> None:
    if impl not in IMPLS:
        raise ValueError(f"{op}: impl={impl!r}, one of {IMPLS}")


def _on_card(*tensors: Optional[torch.Tensor]) -> bool:
    ts = [t for t in tensors if t is not None]
    if ts and all(t.is_cuda for t in ts):
        return True
    if ts and all(t.is_cpu for t in ts):
        return False
    kinds = {t.device.type for t in ts}
    raise ValueError(f"tensors on {sorted(kinds)}: all must be on one CUDA device or the CPU")


def attention(
    q: torch.Tensor,        # [B, Hq, Lq, D]
    k: torch.Tensor,        # [B, Hkv, Lkv, D]
    v: torch.Tensor,
    q_pos: torch.Tensor,    # [B, Lq] int32
    kv_pos: torch.Tensor,   # [B, Lkv] int32 (-1 = invalid)
    *,
    window: int = 0,
    anchor: int = 0,
    causal: bool = False,
    bc_start: int = 0,
    bc_block: int = 0,
    k_scale: Optional[torch.Tensor] = None,   # [B, Hkv, Lkv] f32: k, v are int8 codes
    v_scale: Optional[torch.Tensor] = None,
    impl: str = "kernel",
) -> torch.Tensor:
    """Rectangular GQA attention with position-based masking -> [B, Hq, Lq, D].
    With ``k_scale``/``v_scale``, ``k``/``v`` are int8 codes read with their
    per-(token, head) scales: the kernel dequantizes as it reads, so the
    cache is never widened.  ``impl="plain"`` runs the plain version on
    either device, and on fake tensors (the dry run's train step)."""
    _check_impl("attention", impl)
    kw = dict(window=window, anchor=anchor, causal=causal, bc_start=bc_start,
              bc_block=bc_block, k_scale=k_scale, v_scale=v_scale)
    if fake.is_fake(q, k, v) and impl == "kernel":
        return fake.attention(q, k, v, q_pos, kv_pos, k_scale=k_scale, v_scale=v_scale)
    if _on_card(q, k, v, q_pos, kv_pos, k_scale, v_scale) and impl == "kernel":
        return flash_attention(q, k, v, q_pos, kv_pos, **kw)
    return ref.attention_reference(q, k, v, q_pos, kv_pos, **kw)


def paged_attention(
    q: torch.Tensor,             # [B, Hq, Lq, D]
    k_pool: torch.Tensor,        # [P, ps, Hkv, D] shared page pool
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
    k_scale: Optional[torch.Tensor] = None,   # [P, ps, Hkv] f32: the pools are int8 codes
    v_scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Attention over a page pool through a block table -> [B, Hq, Lq, D].
    Rows of unmapped pages are masked (the reference's ``paged_kv_mask``);
    the mask options and the int8 scales work as in :func:`attention`."""
    kw = dict(window=window, anchor=anchor, causal=causal, bc_start=bc_start,
              bc_block=bc_block, k_scale=k_scale, v_scale=v_scale)
    if fake.is_fake(q, k_pool, v_pool):
        return fake.attention(q, k_pool, v_pool, q_pos, kv_pos, k_scale=k_scale,
                              v_scale=v_scale, block_tables=block_tables)
    if _on_card(q, k_pool, v_pool, q_pos, kv_pos, block_tables, k_scale, v_scale):
        return paged_flash_attention(q, k_pool, v_pool, q_pos, kv_pos, block_tables, **kw)
    return ref.paged_attention_reference(q, k_pool, v_pool, q_pos, kv_pos, block_tables, **kw)


def window_kv_clamp(kv_pos: torch.Tensor, limit: Optional[torch.Tensor]) -> torch.Tensor:
    """The sliding window's cut: ``kv_pos`` becomes -1 at positions at or
    beyond the row's exclusive horizon ``limit [B]``
    (``core.schedule.window_limit``).  Every attention path masks ``kv_pos
    < 0`` already, so one clamp makes the window the same dense and paged.
    ``limit=None`` returns ``kv_pos`` itself."""
    if limit is None:
        return kv_pos
    return torch.where(kv_pos < limit[:, None], kv_pos, -1)


def gather_pages(pool: torch.Tensor, block_tables: torch.Tensor) -> torch.Tensor:
    """The per-slot dense view ``[B, n_vp * ps, ...]`` of a page pool ``[P,
    ps, ...]`` through ``block_tables [B, n_vp]``; unmapped pages read the
    garbage page 0, which callers mask.  Plain PyTorch on either device: the
    reference computes it in XLA, outside any Pallas kernel (the sparse
    eviction probe is its one caller on the port's paths)."""
    return ref.gather_pages(pool, block_tables)


def scatter_rows(pairs, idx: torch.Tensor, *, row_mask: Optional[torch.Tensor] = None,
                 token_mask: Optional[torch.Tensor] = None) -> None:
    """In place, for one or two ``(cache [B, S, ...], new [B, K, ...])``
    pairs (K and V) sharing ``idx [B, K]``: ``cache[b, idx[b, k]] = new[b, k]``.
    ``idx`` holds distinct in-range rows per batch entry.  ``row_mask [B]``
    (rows a mixed-mode pass does not own) and ``token_mask [B, K]`` (tokens
    a partial refresh leaves alone) leave the cache unwritten where False.
    The quantizing form takes ``((codes [B, S, Hkv, D] int8, scales [B, S,
    Hkv] f32), new [B, K, Hkv, D])`` pairs: the new rows are quantized
    (``ref.quantize_rows``) and their codes and scales written.  One kernel
    launch on the card, which takes the masks (and quantizes) itself."""
    quantized = isinstance(pairs[0][0], tuple)
    if fake.is_fake(idx, *_pair_tensors(pairs)):
        return fake.scatter("quantize_scatter_rows" if quantized else "scatter_rows", pairs,
                            idx, row_mask, token_mask)
    if _on_card(idx, row_mask, token_mask, *_pair_tensors(pairs)):
        kernel = quantize_scatter_rows if quantized else scatter_rows_kernel
        kernel(pairs, idx, row_mask=row_mask, token_mask=token_mask)
    elif quantized:
        for (codes, scales), new in pairs:
            ref.quantize_scatter_rows_reference(codes, scales, new, idx, row_mask, token_mask)
    else:
        for cache, new in pairs:
            ref.scatter_rows_reference(cache, new, idx, row_mask, token_mask)


def _pair_tensors(pairs) -> tuple:
    """Every tensor of the scatter pairs, ``(codes, scales)`` caches opened."""
    out = []
    for cache, new in pairs:
        out += [*cache, new] if isinstance(cache, tuple) else [cache, new]
    return tuple(out)


def scatter_rows_paged(pairs, idx: torch.Tensor, block_tables: torch.Tensor, *,
                       row_mask: Optional[torch.Tensor] = None,
                       token_mask: Optional[torch.Tensor] = None) -> None:
    """In place, for one or two ``(pool [P, ps, ...], new [B, K, ...])``
    pairs: ``pool[bt[b, i // ps], i % ps] = new[b, k]`` for the absolute
    positions ``i = idx[b, k]``; a row of an unmapped page lands on the
    garbage page 0.  The masks and the quantizing form (``(codes, scales)``
    pools) work as in :func:`scatter_rows`.  One kernel launch on the card."""
    quantized = isinstance(pairs[0][0], tuple)
    if fake.is_fake(idx, *_pair_tensors(pairs)):
        return fake.scatter("quantize_scatter_rows_paged" if quantized else
                            "scatter_rows_paged", pairs, idx, block_tables, row_mask, token_mask)
    if _on_card(idx, block_tables, row_mask, token_mask, *_pair_tensors(pairs)):
        kernel = quantize_scatter_rows_paged if quantized else scatter_rows_paged_kernel
        kernel(pairs, idx, block_tables, row_mask=row_mask, token_mask=token_mask)
    elif quantized:
        for (codes, scales), new in pairs:
            ref.quantize_scatter_rows_paged_reference(codes, scales, new, idx, block_tables,
                                                      row_mask, token_mask)
    else:
        for pool, new in pairs:
            ref.scatter_rows_paged_reference(pool, new, idx, block_tables, row_mask, token_mask)


def fork_pages(k: torch.Tensor, v: torch.Tensor, src, dst, *,
               k_scale: Optional[torch.Tensor] = None,
               v_scale: Optional[torch.Tensor] = None) -> None:
    """In place, for the K and V pools ``[G, P, ps, ...]`` (and, int8, their
    scale pools ``[G, P, ps, Hkv]``): the copy-on-write copy ``pool[:,
    dst[f]] = pool[:, src[f]]`` of host-side page lists; ``(p, p)`` pairs
    (the ``(0, 0)`` pads) write nothing.  Raises ``ValueError`` if a page is
    out of range or a real destination is also a source.  One kernel launch
    on the card for K and V, and a second one for the scale pools."""
    pools = [(k, v)] + ([] if k_scale is None else [(k_scale, v_scale)])
    if fake.is_fake(k, v):
        for i, (a, b) in enumerate(pools):
            fake.fork_pages(a, b, src, dst, scales=i > 0)
        return
    if _on_card(k, v, k_scale, v_scale):
        for a, b in pools:
            fork_pages_kernel(a, b, src, dst)
        return
    src, dst = check_fork_lists(src, dst, k.shape[1])
    for pair in pools:
        for pool in pair:
            ref.fork_pages_reference(pool, torch.from_numpy(src), torch.from_numpy(dst))


def importance_score(
    h_new: torch.Tensor,    # [B, K, d]
    h_old: torch.Tensor,    # [B, K, d]; [B, S, d] with idx
    conf: torch.Tensor,     # [B, K]; [B, S] with idx
    *,
    alpha: float,
    eps: float = 1e-8,
    idx: Optional[torch.Tensor] = None,     # [B, K] int32 rows of h_old and conf
) -> torch.Tensor:
    """Paper Eq. 1 importance -> f32 [B, K].  With ``idx`` (a skip stage's
    rows, all in ``[0, S)``), row ``k`` scores against ``h_old[b, idx[b, k]]``
    and ``conf[b, idx[b, k]]``: one kernel launch on the card, no gather."""
    if fake.is_fake(h_new, h_old):
        return fake.score("importance", h_new, h_old, conf, idx)
    if _on_card(h_new, h_old, conf, idx):
        return importance(h_new, h_old, conf, alpha=alpha, eps=eps, idx=idx)
    return ref.importance_reference(h_new, h_old, conf, alpha, eps, idx=idx)


def variation_score(
    h_new: torch.Tensor,    # [B, T, d]
    h_old: torch.Tensor,    # [B, T, d]
    conf: torch.Tensor,     # [B, T]
    *,
    alpha: float,
    eps: float = 1e-8,
) -> torch.Tensor:
    """Adaptive-cache refresh priority ``alpha*conf + (1-alpha)*(1-cosine)`` -> f32 [B, T]."""
    if fake.is_fake(h_new, h_old):
        return fake.score("variation", h_new, h_old, conf)
    if _on_card(h_new, h_old, conf):
        return variation(h_new, h_old, conf, alpha=alpha, eps=eps)
    return ref.variation_reference(h_new, h_old, conf, alpha, eps)


def ssd(
    x: torch.Tensor,         # [B, L, H, P]
    dt: torch.Tensor,        # [B, L, H] f32, positive
    a_log: torch.Tensor,     # [H] f32
    bmat: torch.Tensor,      # [B, L, G, N]
    cmat: torch.Tensor,      # [B, L, G, N]
    *,
    chunk: int = 64,
    init_state: Optional[torch.Tensor] = None,   # [B, H, N, P] f32
    impl: str = "kernel",
) -> tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD scan (Mamba-2) -> ``(y [B, L, H, P] in x's dtype, final
    state [B, H, N, P] f32)``.  The reference's chunk choice and zero-``dt``
    padding (a zero-dt row is an exact no-op: decay 1, contribution 0); the
    chunk step is one kernel launch on the card; the recurrence across
    chunks ``S_c = decay_c S_{c-1} + contrib_c`` (``init_state`` folded into
    chunk 0), the states entering each chunk and ``y_inter = (C exp(cs)) @
    S_in`` are plain PyTorch, as the reference leaves them to XLA.
    ``impl="plain"`` runs the chunk step's plain version on either device."""
    _check_impl("ssd", impl)
    b, l, h, p = x.shape
    g, n = bmat.shape[2], bmat.shape[3]
    ck = min(chunk, l) if l % min(chunk, l) == 0 else chunk
    pad = -l % ck
    if pad:
        x, dt, bmat, cmat = (F.pad(t, (0, 0) * (t.dim() - 2) + (0, pad))
                             for t in (x, dt, bmat, cmat))
    if fake.is_fake(x, dt) and impl == "kernel":
        y_intra, contrib, decay, cs = fake.ssd_chunks(x, dt, a_log, bmat, cmat, ck)
    elif _on_card(x, dt, a_log, bmat, cmat, init_state) and impl == "kernel":
        y_intra, contrib, decay, cs = ssd_chunks_kernel(x.contiguous(), dt.contiguous(),
                                                        a_log, bmat, cmat, chunk=ck)
    else:
        y_intra, contrib, decay, cs = ref.ssd_chunks(x, dt, a_log, bmat, cmat, ck)
    l_p, nc = l + pad, (l + pad) // ck
    if init_state is None:
        init_state = torch.zeros((b, h, n, p), dtype=torch.float32, device=x.device)
    states, s = [], init_state
    for c in range(nc):
        s = decay[:, c, :, None, None] * s + contrib[:, c]
        states.append(s)
    s_in = torch.stack([init_state] + states[:-1], dim=1)            # [B, nC, H, N, P]
    cm = cmat.float().repeat_interleave(h // g, dim=2).reshape(b, nc, ck, h, n)
    cm = cm * torch.exp(cs).reshape(b, nc, ck, h)[..., None]
    y_inter = torch.einsum("bcqhn,bchnp->bcqhp", cm, s_in).reshape(b, l_p, h, p)
    y = y_intra.float() + y_inter
    return y[:, :l].to(x.dtype), states[-1]


__all__ = ["attention", "paged_attention", "window_kv_clamp", "window_block_tables",
           "scatter_rows", "scatter_rows_paged",
           "fork_pages", "importance_score", "variation_score", "ssd"]
