"""Plain PyTorch versions of the port's three kernels.

Each function computes what its hand-written CUDA kernel computes, in the
reference package's layouts.  ``ops`` sends CPU tensors here; on the card
they serve only as the oracle the kernels are held against.
"""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


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
) -> torch.Tensor:
    """GQA attention with materialized f32 scores; a query row with nothing
    valid gives 0.  Returns ``q.dtype`` ``[B, Hq, Lq, D]``."""
    group = q.shape[1] // k.shape[1]
    scale = 1.0 / math.sqrt(q.shape[-1])
    kk = k.float().repeat_interleave(group, dim=1)
    vv = v.float().repeat_interleave(group, dim=1)
    scores = torch.einsum("bhqd,bhkd->bhqk", q.float(), kk) * scale
    mask = attention_mask(q_pos, kv_pos, window=window, anchor=anchor, causal=causal,
                          bc_start=bc_start, bc_block=bc_block)[:, None]
    scores = torch.where(mask, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    probs = torch.where(mask.any(dim=-1, keepdim=True), probs, 0.0)
    return torch.einsum("bhqk,bhkd->bhqd", probs, vv).to(q.dtype)


def scatter_rows_reference(
    cache: torch.Tensor,       # [B, S, ...]
    new: torch.Tensor,         # [B, K, ...]
    idx: torch.Tensor,         # [B, K] int, unique per row
) -> torch.Tensor:
    """In place: ``cache[b, idx[b, k]] = new[b, k]``; returns ``cache``."""
    rows = torch.arange(cache.shape[0], device=cache.device)[:, None]
    cache[rows, idx.long()] = new.to(cache.dtype)
    return cache


def importance_reference(
    h_new: torch.Tensor,       # [B, K, d]
    h_old: torch.Tensor,       # [B, K, d]
    conf: torch.Tensor,        # [B, K]
    alpha: float,
    eps: float = 1e-8,
) -> torch.Tensor:
    """Paper Eq. 1: I = a*c + (1-a) * ||Hn-Ho||_1 / (sqrt(d) * ||Ho||_2 + eps), f32."""
    d = h_new.shape[-1]
    ho = h_old.float()
    diff = (h_new.float() - ho).abs().sum(dim=-1)
    norm = ho.square().sum(dim=-1).sqrt()
    var = diff / (math.sqrt(d) * norm + eps)
    return alpha * conf.float() + (1.0 - alpha) * var
