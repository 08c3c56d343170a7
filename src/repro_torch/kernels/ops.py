"""The port's kernel entry points.

Each op picks its implementation by where its tensors lie: CUDA tensors go
through the hand-written kernel, CPU tensors through the plain PyTorch
version in ``ref``.  There is no fallback: a failed build or launch raises,
and tensors split across devices raise.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.importance import importance
from repro_torch.kernels.scatter_kv import scatter_rows as scatter_rows_kernel


def _on_card(*tensors: torch.Tensor) -> bool:
    kinds = {t.device.type for t in tensors}
    if kinds == {"cuda"}:
        return True
    if kinds == {"cpu"}:
        return False
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
) -> torch.Tensor:
    """Rectangular GQA attention with position-based masking -> [B, Hq, Lq, D]."""
    kw = dict(window=window, anchor=anchor, causal=causal, bc_start=bc_start,
              bc_block=bc_block)
    if _on_card(q, k, v, q_pos, kv_pos):
        return flash_attention(q, k, v, q_pos, kv_pos, **kw)
    return ref.attention_reference(q, k, v, q_pos, kv_pos, **kw)


def scatter_rows(pairs, idx: torch.Tensor) -> None:
    """In place, for one or two ``(cache [B, S, ...], new [B, K, ...])``
    pairs (K and V) sharing ``idx [B, K]``: ``cache[b, idx[b, k]] = new[b, k]``.
    ``idx`` holds distinct in-range rows per batch entry.  One kernel launch
    on the card."""
    if _on_card(idx, *(t for pair in pairs for t in pair)):
        scatter_rows_kernel(pairs, idx)
    else:
        for cache, new in pairs:
            ref.scatter_rows_reference(cache, new, idx)


def importance_score(
    h_new: torch.Tensor,    # [B, K, d]
    h_old: torch.Tensor,    # [B, K, d]
    conf: torch.Tensor,     # [B, K]
    *,
    alpha: float,
    eps: float = 1e-8,
) -> torch.Tensor:
    """Paper Eq. 1 importance -> f32 [B, K]."""
    if _on_card(h_new, h_old, conf):
        return importance(h_new, h_old, conf, alpha=alpha, eps=eps)
    return ref.importance_reference(h_new, h_old, conf, alpha, eps)


__all__ = ["attention", "scatter_rows", "importance_score"]
