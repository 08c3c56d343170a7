"""Plain PyTorch versions of the port's kernels.

Each function computes what its hand-written CUDA kernel computes, in the
reference package's layouts.  ``ops`` sends CPU tensors here; on the card
they serve only as the oracle the kernels are held against.
"""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30
LOG2E = 1.0 / math.log(2.0)
SPLIT_TILE = 64       # KV rows per tile of the split-KV attention kernel


def attention_mask(
    q_pos: torch.Tensor,       # [B, Lq] int
    kv_pos: torch.Tensor,      # [B, Lkv] int (-1 = invalid)
    *,
    window: int = 0,
    anchor: int = 0,
    causal: bool = False,
    bc_start: int = 0,
    bc_block: int = 0,
) -> torch.Tensor:
    """[B, Lq, Lkv] bool attention-allowed mask, the position rule of the
    reference's ``_flash_kernel``: kv_pos < 0 is masked; ``causal`` keeps
    kv_pos <= q_pos; ``window > 0`` keeps |q_pos - kv_pos| <= window, plus
    kv_pos < anchor when ``anchor > 0``; ``bc_block > 0`` is block-causal
    (prompt rows, pos < bc_start, are block -1; a query attends its own and
    earlier blocks)."""
    qp = q_pos[:, :, None].long()
    kp = kv_pos[:, None, :].long()
    mask = kp >= 0
    if causal:
        mask = mask & (kp <= qp)
    if window > 0:
        win = (qp - kp).abs() <= window
        if anchor > 0:
            win = win | (kp < anchor)
        mask = mask & win
    if bc_block > 0:
        qb = torch.where(qp >= bc_start, torch.div(qp - bc_start, bc_block, rounding_mode="floor"), -1)
        kb = torch.where(kp >= bc_start, torch.div(kp - bc_start, bc_block, rounding_mode="floor"), -1)
        mask = mask & (kb <= qb)
    return mask.expand(qp.shape[0], qp.shape[1], kp.shape[2])


def quantize_rows(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``x [..., D]`` -> ``(int8 codes [..., D], f32 scales [...])``, the
    reference's ``_quantize_rows`` bit for bit: per row (a token's head),
    ``scale = max(amax / 127, 1e-8)`` and ``code = clip(round(x / scale),
    -127, 127)`` in f32, ties to even.  A NaN code (a non-finite row) is 0,
    as XLA converts it; the row's scale stays non-finite.  Both divisions
    are by tensors on ``x``'s device: PyTorch's CUDA division by a Python
    scalar multiplies by its reciprocal, which rounds differently."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1)
    scale = torch.maximum(amax / torch.full_like(amax, 127.0),
                          torch.tensor(1e-8, dtype=torch.float32, device=x.device))
    q = torch.round(xf / scale[..., None]).clamp(-127.0, 127.0)
    return torch.where(torch.isnan(q), 0.0, q).to(torch.int8), scale


def dequantize(codes: torch.Tensor, scale: torch.Tensor | None) -> torch.Tensor:
    """f32 K/V rows: ``codes * scale[..., None]`` for int8 codes with their
    per-row scales (the reference's dequant inside its attention scan), or
    the rows themselves in f32 without scales."""
    if scale is None:
        return codes.float()
    return codes.float() * scale[..., None].float()


def attention_reference(
    q: torch.Tensor,           # [B, Hq, Lq, D]
    k: torch.Tensor,           # [B, Hkv, Lkv, D]
    v: torch.Tensor,           # [B, Hkv, Lkv, D]
    q_pos: torch.Tensor,       # [B, Lq]
    kv_pos: torch.Tensor,      # [B, Lkv]
    *,
    window: int = 0,
    anchor: int = 0,
    causal: bool = False,
    bc_start: int = 0,
    bc_block: int = 0,
    k_scale: torch.Tensor | None = None,   # [B, Hkv, Lkv] f32: k, v are int8 codes
    v_scale: torch.Tensor | None = None,
) -> torch.Tensor:
    """GQA attention with materialized f32 scores; a query row with nothing
    valid gives 0.  With ``k_scale``/``v_scale``, ``k``/``v`` are int8 codes
    dequantized in f32 (:func:`dequantize`).  Returns ``q.dtype`` ``[B, Hq,
    Lq, D]``."""
    group = q.shape[1] // k.shape[1]
    scale = 1.0 / math.sqrt(q.shape[-1])
    kk = dequantize(k, k_scale).repeat_interleave(group, dim=1)
    vv = dequantize(v, v_scale).repeat_interleave(group, dim=1)
    scores = torch.einsum("bhqd,bhkd->bhqk", q.float(), kk) * scale
    mask = attention_mask(q_pos, kv_pos, window=window, anchor=anchor, causal=causal,
                          bc_start=bc_start, bc_block=bc_block)[:, None]
    scores = torch.where(mask, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    probs = torch.where(mask.any(dim=-1, keepdim=True), probs, 0.0)
    return torch.einsum("bhqk,bhkd->bhqd", probs, vv).to(q.dtype)


def gather_pages(
    pool: torch.Tensor,           # [P, ps, ...] shared page pool
    block_tables: torch.Tensor,   # [B, n_vp] int page ids, -1 unmapped
) -> torch.Tensor:
    """The per-slot dense view ``[B, n_vp * ps, ...]`` of a page pool.
    Unmapped virtual pages read the garbage page 0; callers mask them."""
    ps = pool.shape[1]
    b, n_vp = block_tables.shape
    flat = pool.reshape((-1,) + tuple(pool.shape[2:]))
    rows = (block_tables.long().clamp(min=0)[..., None] * ps
            + torch.arange(ps, device=pool.device))
    return flat[rows.reshape(b, n_vp * ps)]


def paged_kv_mask(block_tables: torch.Tensor, kv_pos: torch.Tensor,
                  page_size: int) -> torch.Tensor:
    """``kv_pos`` with -1 wherever the virtual page is unmapped."""
    mapped = (block_tables >= 0).repeat_interleave(page_size, dim=1)
    return torch.where(mapped, kv_pos, -1)


def paged_attention_reference(
    q: torch.Tensor,              # [B, Hq, Lq, D]
    k_pool: torch.Tensor,         # [P, ps, Hkv, D]
    v_pool: torch.Tensor,
    q_pos: torch.Tensor,          # [B, Lq]
    kv_pos: torch.Tensor,         # [B, n_vp * ps]
    block_tables: torch.Tensor,   # [B, n_vp]
    *,
    k_scale: torch.Tensor | None = None,   # [P, ps, Hkv] f32: the pools are int8 codes
    v_scale: torch.Tensor | None = None,
    **mask,
) -> torch.Tensor:
    """Attention over a page pool: the reference's XLA mirror, which gathers
    the mapped pages (and their scale pages) into the dense layout and
    attends it with unmapped pages masked.  ``mask`` takes
    :func:`attention_mask`'s options."""
    ps = k_pool.shape[1]
    kv_pos = paged_kv_mask(block_tables, kv_pos, ps)
    k = gather_pages(k_pool, block_tables).transpose(1, 2)
    v = gather_pages(v_pool, block_tables).transpose(1, 2)
    return attention_reference(q, k, v, q_pos, kv_pos, **mask,
                               **_gathered_scales(k_scale, v_scale, block_tables))


def _gathered_scales(k_scale, v_scale, block_tables) -> dict:
    """The scale pools' dense ``[B, Hkv, n_vp * ps]`` views, as keywords."""
    if k_scale is None:
        return {}
    return dict(k_scale=gather_pages(k_scale, block_tables).transpose(1, 2),
                v_scale=gather_pages(v_scale, block_tables).transpose(1, 2))


def split_bounds(lkv: int, n_splits: int, tile: int = SPLIT_TILE) -> list[tuple[int, int]]:
    """The KV ranges ``[start, end)`` of ``n_splits`` splits of whole
    ``tile``-row tiles, ``ceil(n_tiles / n_splits)`` tiles each and the last
    ragged, as the split-KV kernel walks them.  Raises when that length gives
    another number of splits (one would be empty)."""
    n_tiles = max(1, -(-lkv // tile))
    per = -(-n_tiles // n_splits)
    if n_splits < 1 or -(-n_tiles // per) != n_splits:
        raise ValueError(f"{n_splits} splits of whole {tile}-row tiles do not fit "
                         f"{lkv} KV rows without an empty split")
    return [(s * per * tile, min((s + 1) * per * tile, lkv)) for s in range(n_splits)]


def attention_split_reference(
    q: torch.Tensor,           # [B, Hq, Lq, D]
    k: torch.Tensor,           # [B, Hkv, Lkv, D]
    v: torch.Tensor,           # [B, Hkv, Lkv, D]
    q_pos: torch.Tensor,       # [B, Lq]
    kv_pos: torch.Tensor,      # [B, Lkv]
    *,
    n_splits: int,
    window: int = 0,
    anchor: int = 0,
    causal: bool = False,
    bc_start: int = 0,
    bc_block: int = 0,
    k_scale: torch.Tensor | None = None,   # [B, Hkv, Lkv] f32: k, v are int8 codes
    v_scale: torch.Tensor | None = None,
) -> torch.Tensor:
    """:func:`attention_reference` by the split-KV kernel's algebra, in f32:
    each split of :func:`split_bounds` gives its unnormalised output ``O``,
    row max ``m`` and sum ``l`` (scores in the exp2 domain), and the splits
    merge by log-sum-exp in split order -- weight ``2^(m_s - max m) / sum_s
    2^(m_s - max m) l_s``, 0 for a split with ``l = 0``; a row with nothing
    valid in any split gives 0.  Returns ``q.dtype`` ``[B, Hq, Lq, D]``."""
    group = q.shape[1] // k.shape[1]
    scale_log2 = LOG2E / math.sqrt(q.shape[-1])
    kk = dequantize(k, k_scale).repeat_interleave(group, dim=1)
    vv = dequantize(v, v_scale).repeat_interleave(group, dim=1)
    scores = torch.einsum("bhqd,bhkd->bhqk", q.float(), kk) * scale_log2
    mask = attention_mask(q_pos, kv_pos, window=window, anchor=anchor, causal=causal,
                          bc_start=bc_start, bc_block=bc_block)[:, None]
    scores = torch.where(mask, scores, NEG_INF)
    parts = []
    for start, end in split_bounds(k.shape[2], n_splits):
        s, mk = scores[..., start:end], mask[..., start:end]
        m = s.amax(dim=-1, keepdim=True)
        p = torch.where(mk, torch.exp2(s - m), 0.0)
        parts.append((torch.einsum("bhqk,bhkd->bhqd", p, vv[:, :, start:end]), m,
                      p.sum(dim=-1, keepdim=True)))
    m_all = torch.stack([m for _, m, _ in parts]).amax(dim=0)
    weights = [torch.where(l > 0, torch.exp2(m - m_all), 0.0) for _, m, l in parts]
    total = sum(w * l for w, (_, _, l) in zip(weights, parts))
    inv = torch.where(total > 0, 1.0 / total, 0.0)
    out = torch.zeros_like(parts[0][0])
    for w, (o, _, _) in zip(weights, parts):
        out = out + (w * inv) * o
    return out.to(q.dtype)


def paged_attention_split_reference(
    q: torch.Tensor,              # [B, Hq, Lq, D]
    k_pool: torch.Tensor,         # [P, ps, Hkv, D]
    v_pool: torch.Tensor,
    q_pos: torch.Tensor,          # [B, Lq]
    kv_pos: torch.Tensor,         # [B, n_vp * ps]
    block_tables: torch.Tensor,   # [B, n_vp]
    *,
    n_splits: int,
    k_scale: torch.Tensor | None = None,   # [P, ps, Hkv] f32: the pools are int8 codes
    v_scale: torch.Tensor | None = None,
) -> torch.Tensor:
    """:func:`paged_attention_reference` by the split-KV algebra of
    :func:`attention_split_reference`: the splits run over virtual KV rows,
    rows of unmapped pages masked (a split of unmapped pages only weighs 0)."""
    ps = k_pool.shape[1]
    kv_pos = paged_kv_mask(block_tables, kv_pos, ps)
    k = gather_pages(k_pool, block_tables).transpose(1, 2)
    v = gather_pages(v_pool, block_tables).transpose(1, 2)
    return attention_split_reference(q, k, v, q_pos, kv_pos, n_splits=n_splits,
                                     **_gathered_scales(k_scale, v_scale, block_tables))


def keep_mask(idx: torch.Tensor, row_mask: torch.Tensor | None,
          token_mask: torch.Tensor | None) -> torch.Tensor | None:
    """[B, K] bool: the tokens a scatter writes, ``row_mask[:, None] &
    token_mask`` as the reference builds it, or None when every token is
    written."""
    if row_mask is None and token_mask is None:
        return None
    keep = torch.ones(idx.shape, dtype=torch.bool, device=idx.device)
    if row_mask is not None:
        keep = keep & row_mask[:, None]
    if token_mask is not None:
        keep = keep & token_mask
    return keep


def scatter_rows_reference(
    cache: torch.Tensor,       # [B, S, ...]
    new: torch.Tensor,         # [B, K, ...]
    idx: torch.Tensor,         # [B, K] int, unique per row
    row_mask: torch.Tensor | None = None,     # [B] bool: rows not written where False
    token_mask: torch.Tensor | None = None,   # [B, K] bool: tokens not written where False
) -> torch.Tensor:
    """In place: ``cache[b, idx[b, k]] = new[b, k]`` where ``row_mask[b]``
    and ``token_mask[b, k]`` pass; returns ``cache``."""
    rows = torch.arange(cache.shape[0], device=cache.device)[:, None].expand(idx.shape)
    idx, new = idx.long(), new.to(cache.dtype)
    keep = keep_mask(idx, row_mask, token_mask)
    if keep is not None:
        rows, idx, new = rows[keep], idx[keep], new[keep]
    cache[rows, idx] = new
    return cache


def scatter_rows_paged_reference(
    pool: torch.Tensor,           # [P, ps, ...]
    new: torch.Tensor,            # [B, K, ...]
    idx: torch.Tensor,            # [B, K] int absolute positions, unique per row
    block_tables: torch.Tensor,   # [B, n_vp] int, -1 unmapped
    row_mask: torch.Tensor | None = None,     # [B] bool: rows not written where False
    token_mask: torch.Tensor | None = None,   # [B, K] bool: tokens not written where False
) -> torch.Tensor:
    """In place: ``pool[bt[b, i // ps], i % ps] = new[b, k]`` for ``i =
    idx[b, k]`` where both masks pass; a row of an unmapped page lands on
    the garbage page 0.  Returns ``pool``."""
    ps = pool.shape[1]
    idx = idx.long()
    page = torch.gather(block_tables.long(), 1, torch.div(idx, ps, rounding_mode="floor"))
    dest = page.clamp(min=0) * ps + idx % ps
    new = new.to(pool.dtype)
    keep = keep_mask(idx, row_mask, token_mask)
    if keep is not None:
        dest, new = dest[keep], new[keep]
    row = tuple(pool.shape[2:])
    pool.view((-1,) + row)[dest.reshape(-1)] = new.reshape((-1,) + row)
    return pool


def quantize_scatter_rows_reference(
    codes: torch.Tensor,       # [B, S, Hkv, D] int8
    scales: torch.Tensor,      # [B, S, Hkv] f32
    new: torch.Tensor,         # [B, K, Hkv, D] bf16 or f32
    idx: torch.Tensor,         # [B, K] int, unique per row
    row_mask: torch.Tensor | None = None,
    token_mask: torch.Tensor | None = None,
) -> None:
    """In place, the reference's int8 write: :func:`quantize_rows` of the
    new rows, then :func:`scatter_rows_reference` of the codes and of the
    scales."""
    c, s = quantize_rows(new)
    scatter_rows_reference(codes, c, idx, row_mask, token_mask)
    scatter_rows_reference(scales, s, idx, row_mask, token_mask)


def quantize_scatter_rows_paged_reference(
    codes: torch.Tensor,          # [P, ps, Hkv, D] int8
    scales: torch.Tensor,         # [P, ps, Hkv] f32
    new: torch.Tensor,            # [B, K, Hkv, D] bf16 or f32
    idx: torch.Tensor,            # [B, K] int absolute positions, unique per row
    block_tables: torch.Tensor,   # [B, n_vp] int, -1 unmapped
    row_mask: torch.Tensor | None = None,
    token_mask: torch.Tensor | None = None,
) -> None:
    """In place, the paged int8 write: :func:`quantize_rows`, then
    :func:`scatter_rows_paged_reference` of the codes and of the scales."""
    c, s = quantize_rows(new)
    scatter_rows_paged_reference(codes, c, idx, block_tables, row_mask, token_mask)
    scatter_rows_paged_reference(scales, s, idx, block_tables, row_mask, token_mask)


def fork_pages_reference(
    pool: torch.Tensor,        # [G, P, ps, ...]
    src: torch.Tensor,         # [F] int page ids
    dst: torch.Tensor,         # [F] int page ids
) -> torch.Tensor:
    """In place: ``pool[:, dst[f]] = pool[:, src[f]]``.  Every source page is
    gathered before any destination is written, so a destination that is also
    a source would still read its old bytes; ``(p, p)`` pairs rewrite a page
    with itself.  Returns ``pool``."""
    src, dst = src.long(), dst.long()
    pool[:, dst] = pool[:, src]
    return pool


def importance_reference(
    h_new: torch.Tensor,       # [B, K, d]
    h_old: torch.Tensor,       # [B, K, d]; [B, S, d] with idx
    conf: torch.Tensor,        # [B, K]; [B, S] with idx
    alpha: float,
    eps: float = 1e-8,
    idx: torch.Tensor | None = None,       # [B, K] int rows of h_old and conf
) -> torch.Tensor:
    """Paper Eq. 1: I = a*c + (1-a) * ||Hn-Ho||_1 / (sqrt(d) * ||Ho||_2 + eps), f32.
    With ``idx``, ``h_old`` and ``conf`` are first gathered at ``idx``, as the
    skip stage's rows."""
    if idx is not None:
        idx = idx.long()
        h_old = torch.gather(h_old, 1, idx[..., None].expand(-1, -1, h_old.shape[-1]))
        conf = torch.gather(conf, 1, idx)
    d = h_new.shape[-1]
    ho = h_old.float()
    diff = (h_new.float() - ho).abs().sum(dim=-1)
    norm = ho.square().sum(dim=-1).sqrt()
    var = diff / (math.sqrt(d) * norm + eps)
    return alpha * conf.float() + (1.0 - alpha) * var


def variation_reference(
    h_new: torch.Tensor,       # [B, K, d]
    h_old: torch.Tensor,       # [B, K, d]
    conf: torch.Tensor,        # [B, K]
    alpha: float,
    eps: float = 1e-8,
) -> torch.Tensor:
    """Adaptive-cache refresh priority: a*c + (1-a) * (1 - dot / (sqrt(nn*no) + eps)),
    f32.  A zero cached row gives cos 0, the largest variation."""
    hn, ho = h_new.float(), h_old.float()
    dot = (hn * ho).sum(dim=-1)
    nn = (hn * hn).sum(dim=-1)
    no = (ho * ho).sum(dim=-1)
    cos = dot / ((nn * no).sqrt() + eps)
    return alpha * conf.float() + (1.0 - alpha) * (1.0 - cos)


def ssd_chunks(
    x: torch.Tensor,           # [B, L, H, P], L % chunk == 0
    dt: torch.Tensor,          # [B, L, H] positive (post-softplus)
    a_log: torch.Tensor,       # [H]   A = -exp(a_log)
    bmat: torch.Tensor,        # [B, L, G, N]
    cmat: torch.Tensor,        # [B, L, G, N]
    chunk: int,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """The SSD chunk step for every (b, h, chunk) at once, in f32: with
    ``cs`` the inclusive cumsum of ``dt * A`` within the chunk,

        y_intra = ((C B^T) * L) (x dt),  L[i, j] = exp(cs_i - cs_j) for i >= j, else 0
        contrib = sum_i exp(cs_Q - cs_i) dt_i B_i (x) x_i,   decay = exp(cs_Q)

    Head h reads B/C group ``h // (H / G)``.  Returns ``(y_intra [B, L, H, P]
    in x's dtype, contrib [B, nC, H, N, P], decay [B, nC, H], cs [B, L, H])``,
    the last three f32."""
    b, l, h, p = x.shape
    g, n = bmat.shape[2], bmat.shape[3]
    if l % chunk:
        raise ValueError(f"ssd_chunks: L={l} is not a multiple of chunk={chunk}")
    nc, hpg = l // chunk, h // g
    a = -torch.exp(a_log.float())
    xr = x.float().reshape(b, nc, chunk, h, p)
    dtr = dt.float().reshape(b, nc, chunk, h)
    br = bmat.float().reshape(b, nc, chunk, g, n).repeat_interleave(hpg, dim=3)
    cr = cmat.float().reshape(b, nc, chunk, g, n).repeat_interleave(hpg, dim=3)
    cs = torch.cumsum(dtr * a, dim=2)                                 # [B, nC, Q, H]
    tri = torch.ones(chunk, chunk, dtype=torch.bool, device=x.device).tril()
    # the i < j entries are masked before the exp, which may overflow there:
    # the same values as masking after it, and a gradient without 0 * inf
    lmat = torch.exp(torch.where(tri[:, :, None], cs[:, :, :, None, :] - cs[:, :, None, :, :],
                                 -torch.inf))                         # [B, nC, Q, Q, H]
    scores = torch.einsum("bcqhn,bckhn->bcqkh", cr, br) * lmat
    xdt = xr * dtr[..., None]
    y = torch.einsum("bcqkh,bckhp->bcqhp", scores, xdt)
    bscale = br * torch.exp(cs[:, :, -1:, :] - cs)[..., None]
    contrib = torch.einsum("bcqhn,bcqhp->bchnp", bscale, xdt)
    return (y.reshape(b, l, h, p).to(x.dtype), contrib, torch.exp(cs[:, :, -1, :]),
            cs.reshape(b, l, h))


def ssd_chunks_tc(
    x: torch.Tensor,           # [B, L, H, P] bf16, L % chunk == 0
    dt: torch.Tensor,          # [B, L, H] f32
    a_log: torch.Tensor,       # [H] f32
    bmat: torch.Tensor,        # [B, L, G, N] bf16
    cmat: torch.Tensor,        # [B, L, G, N] bf16
    chunk: int,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """``ssd_chunks`` with the roundings of the tensor-core body: the
    products take bf16 operands and sum in f32.  The f32 operands, y_intra's
    left one (the decayed, dt-weighted scores ``(C B^T * exp(cs_i - cs_j)) *
    dt_j``) and contrib's right one (``x * exp(cs_Q - cs_q) dt_q``), are each
    split into a bf16 high part and the bf16 rounding of what it missed, and
    the two products are added; x, B and C are bf16 already.  The same
    outputs, types and layouts as ``ssd_chunks``."""
    b, l, h, p = x.shape
    g, n = bmat.shape[2], bmat.shape[3]
    if l % chunk:
        raise ValueError(f"ssd_chunks_tc: L={l} is not a multiple of chunk={chunk}")
    nc, hpg = l // chunk, h // g
    bf16 = torch.bfloat16
    a = -torch.exp(a_log.float())
    xr = x.float().reshape(b, nc, chunk, h, p)
    dtr = dt.float().reshape(b, nc, chunk, h)
    br = bmat.float().reshape(b, nc, chunk, g, n).repeat_interleave(hpg, dim=3)
    cr = cmat.float().reshape(b, nc, chunk, g, n).repeat_interleave(hpg, dim=3)
    cs = torch.cumsum(dtr * a, dim=2)                                 # [B, nC, Q, H]
    tri = torch.ones(chunk, chunk, dtype=torch.bool, device=x.device).tril()
    scores = torch.einsum("bcqhn,bckhn->bcqkh", cr, br)
    decayed = (scores * torch.exp(cs[:, :, :, None, :] - cs[:, :, None, :, :])
               * dtr[:, :, None, :, :])
    def split(v):
        hi = v.to(bf16).float()
        return hi, (v - hi).to(bf16).float()
    left_hi, left_lo = split(torch.where(tri[:, :, None], decayed, 0.0))
    y = (torch.einsum("bcqkh,bckhp->bcqhp", left_hi, xr)
         + torch.einsum("bcqkh,bckhp->bcqhp", left_lo, xr))
    right_hi, right_lo = split(xr * (torch.exp(cs[:, :, -1:, :] - cs) * dtr)[..., None])
    contrib = (torch.einsum("bcqhn,bcqhp->bchnp", br, right_hi)
               + torch.einsum("bcqhn,bcqhp->bchnp", br, right_lo))
    return (y.reshape(b, l, h, p).to(x.dtype), contrib, torch.exp(cs[:, :, -1, :]),
            cs.reshape(b, l, h))


def ssd_reference(
    x: torch.Tensor,           # [B, L, H, P]
    dt: torch.Tensor,          # [B, L, H]
    a_log: torch.Tensor,       # [H]
    bmat: torch.Tensor,        # [B, L, G, N]
    cmat: torch.Tensor,        # [B, L, G, N]
    init_state: torch.Tensor | None = None,   # [B, H, N, P] f32
) -> tuple[torch.Tensor, torch.Tensor]:
    """The sequential SSD recurrence (Mamba-2), the oracle of the chunked scan:

        S_i = exp(dt_i A) S_{i-1} + dt_i B_i x_i^T,   y_i = C_i^T S_i

    Returns ``(y [B, L, H, P] in x's dtype, final state [B, H, N, P] f32)``."""
    b, l, h, p = x.shape
    g, n = bmat.shape[2], bmat.shape[3]
    a = -torch.exp(a_log.float())
    bm = bmat.float().repeat_interleave(h // g, dim=2)
    cm = cmat.float().repeat_interleave(h // g, dim=2)
    state = (torch.zeros((b, h, n, p), dtype=torch.float32, device=x.device)
             if init_state is None else init_state.float())
    ys = []
    for i in range(l):
        dt_i = dt[:, i].float()
        state = (torch.exp(dt_i * a)[..., None, None] * state
                 + dt_i[..., None, None] * bm[:, i, :, :, None] * x[:, i].float()[:, :, None, :])
        ys.append(torch.einsum("bhn,bhnp->bhp", cm[:, i], state))
    return torch.stack(ys, dim=1).to(x.dtype), state
