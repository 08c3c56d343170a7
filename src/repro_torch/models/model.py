"""The port's model: dense, attention-only, period-1 stacks (LLaDA, Dream).

``run_layers(h, ctx, cache, group_lo, group_hi)`` runs a *segment* of the
stack, so the engine can stop at a skip layer, shrink the active set and
continue, as in the reference, where a ``lax.scan`` over layer groups runs
the segment; here a Python loop over the layers does.  Cache modes
(``ForwardCtx.mode``):

  * ``nocache`` -- the vanilla engine: fresh K/V, no cache;
  * ``prefill`` -- write-through: every row scattered into the KV cache,
    which is then attended;
  * ``decode``  -- one diffusion iteration: only the active rows scattered,
    the whole cache attended.

The KV cache is ``KVCache(k, v)`` of ``[G, B, S, Hkv, Dh]`` planes, or of
``[G, P, ps, Hkv, Dh]`` page pools shared by every slot and addressed through
``ForwardCtx.block_tables`` (paged serving); layer g reads and writes the
views ``k[g]``/``v[g]`` in place.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models.attention import (
    Attention,
    KVCache,
    PagedKVCache,
    _param,
    self_attention,
)
from repro_torch.models.common import mlp_apply, padded_vocab, rms_norm, rope_tables

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def check_supported(cfg: ModelConfig) -> None:
    """Raises NotImplementedError for archs outside this slice of the port."""
    kinds = {cfg.layer_kind(l) for l in range(cfg.n_layers)}
    if (cfg.pattern_period != 1 or kinds != {"attn"} or cfg.moe is not None
            or cfg.sliding_window or cfg.tie_embeddings or cfg.logit_softcap
            or cfg.act != "silu"):
        raise NotImplementedError(
            f"{cfg.name}: the port covers dense, attention-only, period-1 stacks "
            f"(LLaDA-8B, Dream-7B); see ROADMAP.md Queue A for the other families")
    for field in ("param_dtype", "compute_dtype"):
        if getattr(cfg, field) not in DTYPES:
            raise NotImplementedError(f"{field}={getattr(cfg, field)!r}: float32 or bfloat16")


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


class MLP(nn.Module):
    def __init__(self, d_model: int, d_ff: int, device, dtype):
        super().__init__()
        self.w_gate = _param((d_model, d_ff), device, dtype)
        self.w_up = _param((d_model, d_ff), device, dtype)
        self.w_down = _param((d_ff, d_model), device, dtype)


class Block(nn.Module):
    def __init__(self, cfg: ModelConfig, device, dtype):
        super().__init__()
        self.ln1 = _param((cfg.d_model,), device, dtype)
        self.attn = Attention(cfg, device, dtype)
        self.ln2 = _param((cfg.d_model,), device, dtype)
        self.ffn = MLP(cfg.d_model, cfg.d_ff, device, dtype)


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
        vp = padded_vocab(cfg)
        self.embed = _param((vp, cfg.d_model), self.device, self.dtype)
        self.final_norm = _param((cfg.d_model,), self.device, self.dtype)
        self.lm_head = _param((cfg.d_model, vp), self.device, self.dtype)
        self.layers = nn.ModuleList(
            Block(cfg, self.device, self.dtype) for _ in range(cfg.n_layers))

    @torch.no_grad()
    def init(self, generator: torch.Generator) -> "Model":
        """Random init with the reference's scheme (normal x 0.02, output
        projections 0.02/sqrt(2L), norms 1, biases 0) but torch's numbers:
        the values differ from ``repro``'s for the same seed.  ``generator``
        lives on the model's device, so a model on the card is initialised
        there."""
        out_scale = 0.02 / max(2.0 * self.cfg.n_layers, 1.0) ** 0.5
        for name, p in self.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if leaf in ("final_norm", "ln1", "ln2"):
                p.fill_(1.0)
            elif leaf in ("bq", "bk", "bv"):
                p.zero_()
            else:
                std = out_scale if leaf in ("wo", "w_down") else 0.02
                p.normal_(0.0, std, generator=generator)
        return self

    def init_cache(self, batch: int, seq_len: int, *, kv_pages: int = 0,
                   page_size: int = 0) -> KVCache:
        """Zeroed KV planes in the parameter dtype: ``[G, B, S, Hkv, Dh]``, or
        with ``kv_pages`` the page pool ``[G, kv_pages, page_size, Hkv, Dh]``
        shared by every slot (page 0 is the garbage page)."""
        cfg = self.cfg
        if kv_pages:
            if page_size <= 0 or seq_len % page_size:
                raise ValueError(f"page_size {page_size} must divide the sequence {seq_len}")
            shape = (self.n_groups, kv_pages, page_size, cfg.n_kv_heads, cfg.head_dim)
        else:
            shape = (self.n_groups, batch, seq_len, cfg.n_kv_heads, cfg.head_dim)
        return KVCache(torch.zeros(shape, dtype=self.dtype, device=self.device),
                       torch.zeros(shape, dtype=self.dtype, device=self.device))

    def embed_tokens(self, tokens: torch.Tensor) -> torch.Tensor:
        return self.embed[tokens.long()].to(self.compute_dtype)

    def logits(self, h: torch.Tensor) -> torch.Tensor:
        h = rms_norm(h, self.final_norm, self.cfg.rms_eps)
        return h @ self.lm_head.to(h.dtype)

    def run_layers(self, h: torch.Tensor, ctx: ForwardCtx, cache: Optional[KVCache] = None,
                   *, group_lo: int = 0, group_hi: Optional[int] = None) -> torch.Tensor:
        """Runs layers ``[group_lo, group_hi)`` on ``h [B, K, d]``; in the
        prefill/decode modes the cache planes are updated in place."""
        cfg = self.cfg
        group_hi = self.n_groups if group_hi is None else group_hi
        if not 0 <= group_lo < group_hi <= self.n_groups:
            raise ValueError(f"bad layer segment [{group_lo}, {group_hi})")
        use_cache = ctx.mode in ("prefill", "decode") and cache is not None
        rope = rope_tables(ctx.positions, cfg.head_dim, theta=cfg.rope_theta,
                           fraction=cfg.rope_fraction)
        for g in range(group_lo, group_hi):
            layer = self.layers[g]
            kv = KVCache(cache.k[g], cache.v[g]) if use_cache else None
            if kv is not None and ctx.block_tables is not None:
                kv = PagedKVCache(kv, ctx.block_tables)
            h = h + self_attention(
                layer.attn, cfg, rms_norm(h, layer.ln1, cfg.rms_eps), ctx.positions,
                cache=kv, slot_idx=ctx.slot_idx, kv_pos=ctx.kv_pos, rope=rope,
                scatter_mask=ctx.scatter_mask, token_mask=ctx.refresh_mask)
            h = h + mlp_apply(layer.ffn, rms_norm(h, layer.ln2, cfg.rms_eps))
        return h
