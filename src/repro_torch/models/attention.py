"""Self-attention with the in-place KV-cache scatter of ES-dLLM (Alg. 1), and
cross-attention to the encoder's tokens.

Three cache modes, as in the reference: no cache (the vanilla engine: fresh
K/V), write-through (prefill: every row scattered, then the cache attended)
and partial (decode: only the active rows scattered, the whole cache
attended).  The cache is updated in place: ``KVCache.k``/``v`` are views of
the model's ``[G, B, S, Hkv, Dh]`` planes, or of its ``[G, P, ps, Hkv, Dh]``
page pool (``PagedKVCache``), and the scatter kernel writes into them.

The int8 cache (``Model.init_cache(kv_dtype="int8")``) holds int8 codes
with f32 per-(token, head) scales: the scatter kernel quantizes the fresh
rows as it writes them, and the attention kernels read the codes and the
scales, so no layer's cache is ever widened.

Under tensor parallelism (``Model(cfg, mesh=...)``) each rank's
``Attention`` holds its whole query heads and the KV heads they read
(``sharding/specs.py``: ``heads``, ``kv_heads``), and ``wo`` the matching
rows: the projections and the kernels run at the local head counts, which
they read from the weights, and ``Model.run_layers`` sums the output over
the ranks once, after ``@ wo``; so do a cross layer's and the encoder's
attention, whose cross planes hold the rank's KV heads.

Cross-attention (``cross_attention``) reads a fixed key set, the encoder's
tokens, with no RoPE and no mask: its K/V are projected from the encoder
output once per prefill and kept in a per-slot cross plane, which the
decode passes read.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models.common import rope_tables, rotate


class KVCache(NamedTuple):
    """KV cache rows: dense ``[B, S, Hkv, Dh]`` or a page pool ``[P, ps, Hkv,
    Dh]`` for one layer, stacked ``[G, ...]`` over the layers
    (``Model.init_cache``)."""
    k: torch.Tensor
    v: torch.Tensor

    k_scale = v_scale = property(lambda self: None)   # no scales: not quantized
    quantized = property(lambda self: False)

    def layer(self, g: int) -> "KVCache":
        """Layer ``g``'s views of every plane."""
        return KVCache(self.k[g], self.v[g])


class QuantKVCache(NamedTuple):
    """The int8 cache (``Model.init_cache(kv_dtype="int8")``): ``k``/``v``
    int8 codes in :class:`KVCache`'s layouts and their f32 per-(token, head)
    scales ``k_scale``/``v_scale`` ``[B, S, Hkv]`` (``[P, ps, Hkv]``), the
    reference's quantized ``KVCache``."""
    k: torch.Tensor
    v: torch.Tensor
    k_scale: torch.Tensor
    v_scale: torch.Tensor

    quantized = property(lambda self: True)

    def layer(self, g: int) -> "QuantKVCache":
        return QuantKVCache(*(t[g] for t in self))


class PagedKVCache(NamedTuple):
    """Block-table view over one layer's page pool ``[P, ps, Hkv, Dh]``:
    ``block_tables[b, vp]`` maps slot ``b``'s virtual page ``vp`` (positions
    ``[vp*ps, (vp+1)*ps)``) to a physical page, -1 for unmapped (masked on
    read, written to the garbage page 0).  ``read_tables`` is the table the
    attention read walks, the sliding window's view of it
    (``ops.window_block_tables``), or None for the table itself.  Page
    ownership lives in the scheduler's allocator."""
    cache: KVCache | QuantKVCache
    block_tables: torch.Tensor          # [B, n_vp] int32
    read_tables: Optional[torch.Tensor] = None   # [B, n_vp] int32


def _param(shape, device, dtype) -> nn.Parameter:
    """A frozen parameter: only a trainer turns grads on
    (``model.requires_grad_(True)``), so no inference pass records a graph."""
    return nn.Parameter(torch.empty(shape, device=device, dtype=dtype), requires_grad=False)


class Attention(nn.Module):
    """Projections for ``x @ W`` (weights ``[in, out]``, the reference's
    layout), with the optional qkv bias (Dream).  A cross-attention layer's
    (``cross=True``) has no bias, and its ``wk``/``wv`` take ``kv_width``
    inputs, the width of the encoder tokens it reads (the reference's
    ``attn_init``)."""

    def __init__(self, cfg: ModelConfig, device, dtype, *, cross: bool = False,
                 kv_width: Optional[int] = None):
        super().__init__()
        d, h, hkv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        d_kv = (kv_width or cfg.d_enc or d) if cross else d
        self.wq = _param((d, h * dh), device, dtype)
        self.wk = _param((d_kv, hkv * dh), device, dtype)
        self.wv = _param((d_kv, hkv * dh), device, dtype)
        self.wo = _param((h * dh, d), device, dtype)
        if cfg.qkv_bias and not cross:
            self.bq = _param((h * dh,), device, dtype)
            self.bk = _param((hkv * dh,), device, dtype)
            self.bv = _param((hkv * dh,), device, dtype)
        else:
            self.bq = self.bk = self.bv = None


def local_heads(p: Attention, cfg: ModelConfig) -> tuple[int, int]:
    """``(query heads, KV heads)`` that ``p`` holds: the config's, or a
    tensor-parallel rank's share of them."""
    return p.wq.shape[1] // cfg.head_dim, p.wk.shape[1] // cfg.head_dim


def _project_qkv(p: Attention, cfg: ModelConfig, x, rope):
    b, k, _ = x.shape
    (h, hkv), dh = local_heads(p, cfg), cfg.head_dim
    q = x @ p.wq
    kk = x @ p.wk
    vv = x @ p.wv
    if p.bq is not None:
        q = q + p.bq
        kk = kk + p.bk
        vv = vv + p.bv
    return (rotate(q.reshape(b, k, h, dh), rope), rotate(kk.reshape(b, k, hkv, dh), rope),
            vv.reshape(b, k, hkv, dh))


def self_attention(
    p: Attention,
    cfg: ModelConfig,
    x: torch.Tensor,                        # [B, K, d] active rows
    positions: torch.Tensor,                # [B, K] int32 global positions
    *,
    cache: Optional[KVCache | QuantKVCache | PagedKVCache] = None,   # views, in place
    slot_idx: Optional[torch.Tensor] = None,   # [B, K] int32 cache rows to write
    kv_pos: Optional[torch.Tensor] = None,     # [B, S] int32 cache validity (-1 invalid)
    rope=None,                      # common.rope_tables(positions, ...), if precomputed
    scatter_mask: Optional[torch.Tensor] = None,   # [B] rows whose K/V are written
    token_mask: Optional[torch.Tensor] = None,     # [B, K] tokens whose K/V are written
    window: int = 0,                # per-layer local attention (0 = none)
    anchor: int = 0,
    bc_start: int = 0,              # block-causal: first generation position
    bc_block: int = 0,              # block-causal block length; 0 = off
    impl: str = "kernel",           # ops.attention's: "plain" is differentiable
) -> torch.Tensor:
    """Returns the attention output ``[B, K, d]``; with a cache, first
    scatters the fresh K/V rows into it, then attends the whole cache.

    ``scatter_mask`` (mixed-mode cadence) leaves the rows a pass does not own
    unwritten; ``token_mask`` (adaptive partial refresh, block-causal
    refresh exemption) the tokens of owned rows that keep their cached K/V.
    Reads are unmasked: unowned rows still compute, and the engine merges
    their outputs away.  The mask options reach both kernels.

    Under the sliding window ``kv_pos`` arrives clamped at the row's horizon
    (``ops.window_kv_clamp``) and a paged read walks ``cache.read_tables``
    (``ops.window_block_tables``); ``Model.run_layers`` makes both once per
    segment.  Writes keep the real table: a block entry's full refresh
    rewrites beyond-window rows before any read sees them."""
    b, k, _ = x.shape
    if rope is None:
        rope = rope_tables(positions, cfg.head_dim, theta=cfg.rope_theta,
                           fraction=cfg.rope_fraction)
    q, kk, vv = _project_qkv(p, cfg, x, rope)
    masks = dict(row_mask=scatter_mask, token_mask=token_mask)
    opts = dict(window=window, anchor=anchor, bc_start=bc_start, bc_block=bc_block)
    if cache is not None and (slot_idx is None or kv_pos is None):
        raise ValueError("a cached attention needs slot_idx and kv_pos")
    if isinstance(cache, PagedKVCache):
        pool, bt = cache.cache, cache.block_tables
        ops.scatter_rows_paged(_write_pairs(pool, kk, vv), slot_idx, bt, **masks)
        read_bt = bt if cache.read_tables is None else cache.read_tables
        out = ops.paged_attention(q.transpose(1, 2), *_read_planes(pool, q.dtype), positions,
                                  kv_pos, read_bt, k_scale=pool.k_scale, v_scale=pool.v_scale,
                                  **opts)
        return out.transpose(1, 2).reshape(b, k, -1) @ p.wo
    scales = {}
    if cache is not None:
        ops.scatter_rows(_write_pairs(cache, kk, vv), slot_idx, **masks)
        (k_full, v_full), kv_positions = _read_planes(cache, q.dtype), kv_pos
        if cache.quantized:        # [B, Hkv, S] views of the scale planes
            scales = dict(k_scale=cache.k_scale.transpose(1, 2),
                          v_scale=cache.v_scale.transpose(1, 2))
    else:
        k_full, v_full, kv_positions = kk, vv, positions
    out = ops.attention(
        q.transpose(1, 2),                                    # [B, H, K, Dh] views
        k_full.transpose(1, 2),
        v_full.transpose(1, 2),
        positions,
        kv_positions,
        **scales,
        **opts,
        impl=impl,
    )
    return out.transpose(1, 2).reshape(b, k, -1) @ p.wo


def cross_attention(
    p: Attention,
    cfg: ModelConfig,
    x: torch.Tensor,                        # [B, K, d] active rows
    *,
    enc_out: Optional[torch.Tensor] = None,    # [B, E, kv_width] encoder output
    cache: Optional[KVCache] = None,           # [B, E, Hkv, Dh] views of a cross plane
    impl: str = "kernel",                      # ops.attention's
) -> tuple[torch.Tensor, tuple[torch.Tensor, torch.Tensor]]:
    """Cross-attention to the encoder's ``E`` tokens, the reference's
    ``cross_attention``: no RoPE on either side, every query at position 0
    and the keys at ``0..E-1``, so no key is masked.  With ``cache`` its K/V
    are read; without, they are projected from ``enc_out``.  Returns the
    output ``[B, K, d]`` and the K/V ``[B, E, Hkv, Dh]`` it attended, which a
    prefill stores in the cross plane."""
    b, k, _ = x.shape
    (h, hkv), dh = local_heads(p, cfg), cfg.head_dim
    q = (x @ p.wq).reshape(b, k, h, dh)
    if cache is None:
        if enc_out is None:
            raise ValueError("a cross-attention layer needs enc_out or its cross cache")
        e = enc_out.shape[1]
        # the encoder output is float32, as in the reference; under bf16
        # parameters (port only) it is cast to the compute dtype here, before
        # the K/V projections, since torch's matmul takes one dtype
        enc = enc_out.to(x.dtype)
        ck = (enc @ p.wk).reshape(b, e, hkv, dh)
        cv = (enc @ p.wv).reshape(b, e, hkv, dh)
    else:
        ck, cv = cache.k.to(q.dtype), cache.v.to(q.dtype)
    e = ck.shape[1]
    q_pos = torch.zeros((b, k), dtype=torch.int32, device=x.device)
    kv_pos = torch.arange(e, dtype=torch.int32, device=x.device)[None].expand(b, e).contiguous()
    out = ops.attention(q.transpose(1, 2), ck.transpose(1, 2), cv.transpose(1, 2), q_pos, kv_pos,
                        impl=impl)
    return out.transpose(1, 2).reshape(b, k, -1) @ p.wo, (ck, cv)


def _write_pairs(cache: KVCache | QuantKVCache, kk: torch.Tensor, vv: torch.Tensor) -> tuple:
    """The scatter's ``(cache, new)`` pairs: the K and V planes with the new
    rows in their dtype, or, quantized, the ``(codes, scales)`` planes with
    the new rows as they are (the scatter kernel quantizes them)."""
    if cache.quantized:
        return ((cache.k, cache.k_scale), kk), ((cache.v, cache.v_scale), vv)
    return (cache.k, kk.to(cache.k.dtype)), (cache.v, vv.to(cache.v.dtype))


def _read_planes(cache: KVCache | QuantKVCache, dtype: torch.dtype) -> tuple:
    """The K and V planes the attention reads: the int8 codes as they are
    (the kernels take their scales), else in the queries' dtype."""
    if cache.quantized:
        return cache.k, cache.v
    return cache.k.to(dtype), cache.v.to(dtype)
