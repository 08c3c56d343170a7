"""The port's model: period-1 stacks, attention-only with a dense or an MoE
FFN (LLaDA, Dream, Llama-3, Qwen2, ChatGLM3, Gemma-3 with its local:global
windows; OLMoE, Granite-MoE) or pure SSM (Mamba-2).

``run_layers(h, ctx, cache, group_lo, group_hi)`` runs a *segment* of the
stack, so the engine can stop at a skip layer, shrink the active set and
continue, as in the reference, where a ``lax.scan`` over layer groups runs
the segment; here a Python loop over the layers does.  Cache modes
(``ForwardCtx.mode``):

  * ``nocache`` -- the vanilla engine: fresh K/V, the full SSD scan, no cache;
  * ``prefill`` -- write-through: every row scattered into the KV cache,
    which is then attended; an SSM layer captures its state and conv tail
    at the block start and the block rows of its output into ``ssmh``;
  * ``decode``  -- one diffusion iteration: only the active rows scattered,
    the whole cache attended; an SSM layer scatters the active rows into
    ``ssmh``, runs the mixer over that whole block from the cached
    block-start state and gathers the active rows back (the reference's
    dense rejoin).

The KV cache is ``KVCache(k, v)`` of ``[G, B, S, Hkv, Dh]`` planes, or of
``[G, P, ps, Hkv, Dh]`` page pools shared by every slot and addressed through
``ForwardCtx.block_tables`` (paged serving), or ``QuantKVCache`` with
``k_scale``/``v_scale`` planes beside int8 codes; layer g reads and writes
the views ``k[g]``/``v[g]`` (and its scales) in place.  An SSM stack's cache is ``SSMCache``
(``state``, ``conv_tail``, ``ssmh``), written in place too; under a
``scatter_mask`` only the owned rows are written.

Prefill stores each SSM layer's *output* block rows in ``ssmh``, while a
decode scatters the layer's *input* rows into it and runs the mixer on that
buffer as the layer's input: the reference does so
(``repro/models/model.py:_apply_ssm``), and the port mirrors it so that its
tokens stay equal to the reference's (ROADMAP.md Queue C).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.models.attention import (
    Attention,
    KVCache,
    PagedKVCache,
    QuantKVCache,
    _param,
    self_attention,
)
from repro_torch.models.common import (
    mlp_apply,
    padded_vocab,
    rms_norm,
    rope_tables,
    row_gather,
    row_scatter,
)
from repro_torch.models.mamba import Mixer, SSMCache, SSMState, init_ssm_state, mamba_apply
from repro_torch.models.moe import MoE, moe_apply

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def check_supported(cfg: ModelConfig) -> None:
    """Raises NotImplementedError for archs outside the port so far."""
    kinds = {cfg.layer_kind(l) for l in range(cfg.n_layers)}
    ssm_only = kinds == {"ssm"} and cfg.family == "ssm" and cfg.ssm is not None
    if (cfg.pattern_period != 1 or not (kinds == {"attn"} or ssm_only)
            or cfg.family in ("hybrid", "audio", "vlm") or cfg.logit_softcap):
        raise NotImplementedError(
            f"{cfg.name}: the port covers period-1 stacks that are attention-only (dense "
            f"or MoE FFN, per-layer windows) or pure SSM; see ROADMAP.md Queue A for "
            f"the other families")
    for field in ("param_dtype", "compute_dtype"):
        if getattr(cfg, field) not in DTYPES:
            raise NotImplementedError(f"{field}={getattr(cfg, field)!r}: float32 or bfloat16")


def layer_window(cfg: ModelConfig, layer: int, window_override: int = 0) -> int:
    """Layer ``layer``'s local attention window, 0 for none: the reference's
    ``window_meta``, with 0 where it has ``BIG_WINDOW`` (a global layer of a
    local:global interleave, or a stack without windows), which masks the
    same keys below 2**30 positions and keeps the kernels off their options
    path.  A non-zero ``window_override`` caps every layer's."""
    w = cfg.sliding_window if cfg.sliding_window and not cfg.layer_is_global_attn(layer) else 0
    if window_override:
        w = min(w, window_override) if w else window_override
    return w


@dataclasses.dataclass
class ForwardCtx:
    positions: torch.Tensor                    # [B, K] int32 global positions of rows
    mode: str = "nocache"                      # nocache | prefill | decode
    kv_pos: Optional[torch.Tensor] = None      # [B, S] int32 cache validity (-1 invalid)
    slot_idx: Optional[torch.Tensor] = None    # [B, K] int32 cache rows to scatter
    block_tables: Optional[torch.Tensor] = None   # [B, n_vp] int32 page map: the cache
                                                  # is a pool (its dim 1 is the page size)
    scatter_mask: Optional[torch.Tensor] = None   # [B] bool: rows whose K/V scatters
                                                  # land (mixed-mode cadence)
    refresh_mask: Optional[torch.Tensor] = None   # [B, K] bool: tokens whose K/V
                                                  # scatters land (partial refresh)
    block_idx: Optional[torch.Tensor] = None      # [B, K] int32 block-local rows (SSM
                                                  # decode: the dense rejoin)
    block_start: Optional[torch.Tensor] = None    # [B] int32 block start (SSM prefill:
                                                  # the state capture)
    window_limit: Optional[torch.Tensor] = None   # [B] int32 sliding-window horizon
                                                  # (core.schedule.window_limit): kv
                                                  # positions at or past it are not read
    window_override: int = 0                      # caps every layer's local window
    anchor: int = 0                               # positions below it bypass the window
    bc_start: int = 0                             # block-causal: first generation position
    bc_block: int = 0                             # block-causal block length; 0 = off


class MLP(nn.Module):
    def __init__(self, d_model: int, d_ff: int, device, dtype):
        super().__init__()
        self.w_gate = _param((d_model, d_ff), device, dtype)
        self.w_up = _param((d_model, d_ff), device, dtype)
        self.w_down = _param((d_ff, d_model), device, dtype)


class Block(nn.Module):
    """``ln1`` + attention + ``ln2`` + the FFN (a gated MLP, or the experts
    where ``cfg.layer_is_moe``), or for a pure SSM stack ``ln1`` + mixer (no
    FFN, as the reference decides for ``family="ssm"``)."""

    def __init__(self, cfg: ModelConfig, layer: int, device, dtype):
        super().__init__()
        self.ln1 = _param((cfg.d_model,), device, dtype)
        if cfg.family == "ssm":
            self.mixer = Mixer(cfg, device, dtype)
            return
        self.attn = Attention(cfg, device, dtype)
        self.ln2 = _param((cfg.d_model,), device, dtype)
        self.moe = cfg.layer_is_moe(layer)
        self.ffn = (MoE(cfg, device, dtype) if self.moe
                    else MLP(cfg.d_model, cfg.d_ff, device, dtype))


def _store(dst: torch.Tensor, new: torch.Tensor, row_mask: Optional[torch.Tensor]) -> None:
    """In place ``dst[:] = new`` on the rows of ``row_mask`` (all rows without
    one): a pass leaves the SSM caches of the rows it does not own as they
    were, as the reference's per-row merge of a pass's outputs does."""
    new = new.to(dst.dtype)
    if row_mask is not None:
        new = torch.where(row_mask.view((-1,) + (1,) * (new.dim() - 1)), new, dst)
    dst.copy_(new)


class Model(nn.Module):
    """Parameters are allocated (uninitialised) on ``device``; fill them with
    :meth:`init` or ``load_state_dict(convert.params_from_numpy(...))``."""

    def __init__(self, cfg: ModelConfig, *, device: str | torch.device | None = None):
        super().__init__()
        cfg.validate()
        check_supported(cfg)
        self.cfg = cfg
        self.device = resolve_device(device)
        self.dtype = DTYPES[cfg.param_dtype]
        self.compute_dtype = DTYPES[cfg.compute_dtype]
        self.n_groups = cfg.n_layers           # period 1: one layer per group
        self.ssm = cfg.family == "ssm"
        vp = padded_vocab(cfg)
        self.embed = _param((vp, cfg.d_model), self.device, self.dtype)
        self.final_norm = _param((cfg.d_model,), self.device, self.dtype)
        # tied embeddings: the head is embed.T, there is no lm_head
        self.lm_head = (None if cfg.tie_embeddings
                        else _param((cfg.d_model, vp), self.device, self.dtype))
        self.layers = nn.ModuleList(
            Block(cfg, l, self.device, self.dtype) for l in range(cfg.n_layers))

    @torch.no_grad()
    def init(self, generator: torch.Generator) -> "Model":
        """Random init with the reference's scheme (normal x 0.02, the
        router too, output projections and each expert's ``w_down``
        0.02/sqrt(2L), norms 1, biases 0; the mixer's conv taps x 0.2,
        ``a_log`` 0, ``dt_bias`` -1, ``d_skip`` 1) but torch's numbers:
        the values differ from ``repro``'s for the same seed.  ``generator``
        lives on the model's device, so a model on the card is initialised
        there."""
        out_scale = 0.02 / max(2.0 * self.cfg.n_layers, 1.0) ** 0.5
        for name, p in self.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if leaf in ("final_norm", "ln1", "ln2", "norm_scale", "d_skip"):
                p.fill_(1.0)
            elif leaf in ("bq", "bk", "bv", "conv_xb", "conv_bcb", "a_log"):
                p.zero_()
            elif leaf == "dt_bias":
                p.fill_(-1.0)
            else:
                std = {"wo": out_scale, "w_down": out_scale, "out_proj": out_scale,
                       "conv_x": 0.2, "conv_bc": 0.2}.get(leaf, 0.02)
                p.normal_(0.0, std, generator=generator)
        return self

    def init_cache(self, batch: int, seq_len: int, *, block_len: int = 0, kv_pages: int = 0,
                   page_size: int = 0,
                   kv_dtype: Optional[str] = None) -> KVCache | QuantKVCache | SSMCache:
        """Zeroed caches.  Attention: KV planes in the parameter dtype, ``[G,
        B, S, Hkv, Dh]``, or with ``kv_pages`` the page pool ``[G, kv_pages,
        page_size, Hkv, Dh]`` shared by every slot (page 0 is the garbage
        page); ``kv_dtype="int8"`` makes them a ``QuantKVCache``: int8 codes
        with f32 scale planes ``[G, B, S, Hkv]`` (``[G, kv_pages, page_size,
        Hkv]``).  SSM:
        ``SSMCache`` with ``block_len`` rows of ``ssmh`` per slot; there is
        no paged layout (nothing grows with the sequence) and ``kv_dtype``
        does not apply."""
        if kv_dtype not in (None, "int8"):
            raise ValueError(f"kv_cache_dtype={kv_dtype!r}: None or 'int8'")
        cfg = self.cfg
        if self.ssm:
            if kv_pages or block_len <= 0:
                raise ValueError("an SSM cache is dense and needs block_len > 0")
            base = init_ssm_state(cfg, batch, self.dtype, self.device)
            g = self.n_groups
            return SSMCache(
                base.state[None].repeat(g, 1, 1, 1, 1),
                base.conv_tail[None].repeat(g, 1, 1, 1),
                torch.zeros((g, batch, block_len, cfg.d_model), dtype=self.dtype,
                            device=self.device))
        if kv_pages:
            if page_size <= 0 or seq_len % page_size:
                raise ValueError(f"page_size {page_size} must divide the sequence {seq_len}")
            shape = (self.n_groups, kv_pages, page_size, cfg.n_kv_heads, cfg.head_dim)
        else:
            shape = (self.n_groups, batch, seq_len, cfg.n_kv_heads, cfg.head_dim)

        def zeros(shape, dtype):
            return torch.zeros(shape, dtype=dtype, device=self.device)
        if kv_dtype == "int8":
            return QuantKVCache(zeros(shape, torch.int8), zeros(shape, torch.int8),
                                zeros(shape[:-1], torch.float32),
                                zeros(shape[:-1], torch.float32))
        return KVCache(zeros(shape, self.dtype), zeros(shape, self.dtype))

    def embed_tokens(self, tokens: torch.Tensor) -> torch.Tensor:
        return self.embed[tokens.long()].to(self.compute_dtype)

    def logits(self, h: torch.Tensor) -> torch.Tensor:
        h = rms_norm(h, self.final_norm, self.cfg.rms_eps)
        head = self.embed.T if self.lm_head is None else self.lm_head
        return h @ head.to(h.dtype)

    def run_layers(self, h: torch.Tensor, ctx: ForwardCtx,
                   cache: Optional[KVCache | SSMCache] = None, *, group_lo: int = 0,
                   group_hi: Optional[int] = None) -> torch.Tensor:
        """Runs layers ``[group_lo, group_hi)`` on ``h [B, K, d]``; in the
        prefill/decode modes the caches are updated in place.  The sliding
        window's clamp of ``kv_pos`` and its read view of the block table
        are made once here for the whole segment."""
        cfg = self.cfg
        group_hi = self.n_groups if group_hi is None else group_hi
        if not 0 <= group_lo < group_hi <= self.n_groups:
            raise ValueError(f"bad layer segment [{group_lo}, {group_hi})")
        use_cache = ctx.mode in ("prefill", "decode") and cache is not None
        if self.ssm:
            for g in range(group_lo, group_hi):
                h = self._apply_ssm(self.layers[g], g, h, ctx, cache if use_cache else None)
            return h
        rope = rope_tables(ctx.positions, cfg.head_dim, theta=cfg.rope_theta,
                           fraction=cfg.rope_fraction)
        kv_pos, read_bt = ctx.kv_pos, None
        if use_cache and ctx.window_limit is not None:
            kv_pos = ops.window_kv_clamp(kv_pos, ctx.window_limit)
            if ctx.block_tables is not None:
                read_bt = ops.window_block_tables(ctx.block_tables, ctx.window_limit,
                                                  cache.k.shape[2])
        for g in range(group_lo, group_hi):
            layer = self.layers[g]
            kv = cache.layer(g) if use_cache else None
            if kv is not None and ctx.block_tables is not None:
                kv = PagedKVCache(kv, ctx.block_tables, read_bt)
            h = h + self_attention(
                layer.attn, cfg, rms_norm(h, layer.ln1, cfg.rms_eps), ctx.positions,
                cache=kv, slot_idx=ctx.slot_idx, kv_pos=kv_pos, rope=rope,
                scatter_mask=ctx.scatter_mask, token_mask=ctx.refresh_mask,
                window=layer_window(cfg, g, ctx.window_override), anchor=ctx.anchor,
                bc_start=ctx.bc_start, bc_block=ctx.bc_block)
            hn = rms_norm(h, layer.ln2, cfg.rms_eps)
            h = h + (moe_apply(layer.ffn, cfg, hn) if layer.moe
                     else mlp_apply(layer.ffn, hn, cfg.act))
        return h

    def _apply_ssm(self, layer: Block, g: int, h: torch.Tensor, ctx: ForwardCtx,
                   cache: Optional[SSMCache]) -> torch.Tensor:
        """One SSM layer, the reference's ``_apply_ssm``: decode rebuilds the
        block from ``ssmh`` and resumes from the block-start state, prefill
        captures that state and the block rows of the layer's output."""
        cfg = self.cfg
        if ctx.mode == "decode" and cache is not None:
            if ctx.block_idx is None:
                raise ValueError("an SSM decode needs block_idx")
            full_in = row_scatter(cache.ssmh[g], h, ctx.block_idx)
            y_full, _, _ = mamba_apply(
                layer.mixer, cfg, rms_norm(full_in, layer.ln1, cfg.rms_eps),
                state=SSMState(cache.state[g], cache.conv_tail[g]))
            h = h + row_gather(y_full, ctx.block_idx).to(h.dtype)
            _store(cache.ssmh[g], full_in, ctx.scatter_mask)   # the state stays at block start
            return h
        capture = None
        if ctx.mode == "prefill" and cache is not None:
            if ctx.block_start is None:
                raise ValueError("an SSM prefill needs block_start")
            capture = ctx.block_start
        y, _, captured = mamba_apply(layer.mixer, cfg, rms_norm(h, layer.ln1, cfg.rms_eps),
                                     capture_pos=capture)
        h = h + y.to(h.dtype)
        if capture is not None:
            lb = cache.ssmh.shape[2]
            cols = capture[:, None] + torch.arange(lb, dtype=capture.dtype, device=h.device)
            _store(cache.state[g], captured.state, ctx.scatter_mask)
            _store(cache.conv_tail[g], captured.conv_tail, ctx.scatter_mask)
            _store(cache.ssmh[g], row_gather(h, cols), ctx.scatter_mask)
        return h
