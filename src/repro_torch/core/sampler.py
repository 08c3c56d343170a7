"""Greedy confidence, unmasking policy and premature-EOS guard.

The port covers temperature-0 decoding (LLaDA's low-confidence remasking,
with optional Fast-dLLM parallel decoding); sampled decoding is outside this
slice.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import GenerationConfig

NEG_INF = -1e30


def _mask_invalid_vocab(logits: torch.Tensor, vocab_size: int, mask_id: int) -> torch.Tensor:
    """Disallow pad-vocab rows and the [mask] token itself."""
    ids = torch.arange(logits.shape[-1], device=logits.device)
    bad = (ids >= vocab_size) | (ids == mask_id)
    return torch.where(bad, NEG_INF, logits)


def confidence_and_pred(
    logits: torch.Tensor,       # [B, K, V]
    vocab_size: int,
    mask_id: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Greedy: returns (conf [B, K] f32, the probability of the chosen token,
    and pred [B, K] int32, the first-index argmax of the f32 softmax)."""
    probs = torch.softmax(_mask_invalid_vocab(logits.float(), vocab_size, mask_id), dim=-1)
    pred = torch.argmax(probs, dim=-1)
    conf = torch.amax(probs, dim=-1)
    return conf, pred.to(torch.int32)


def select_unmask(
    conf: torch.Tensor,         # [B, Lb] confidence cache (stale for skipped rows)
    is_masked: torch.Tensor,    # [B, Lb] bool
    gen: GenerationConfig,
    n_per_step: int,
) -> torch.Tensor:
    """Bool [B, Lb]: which positions to unmask this iteration.

    The top ``n_per_step`` masked positions by confidence (ties allowed:
    every position at the threshold value unmasks); parallel decoding also
    unmasks every masked position above ``pd_threshold``."""
    cand = torch.where(is_masked, conf, NEG_INF)
    n = max(1, n_per_step)
    thresh_val = torch.sort(cand, dim=-1).values[:, -n][:, None]
    top_n = (cand >= thresh_val) & is_masked
    if gen.parallel_decoding:
        return ((cand > gen.pd_threshold) | top_n) & is_masked
    return top_n


def disallow_premature_eos(
    logits: torch.Tensor,          # [B, K, V]
    any_mask_after: torch.Tensor,  # [B, K] bool: a mask token still follows
    eos_id: int,
) -> torch.Tensor:
    """Disallow EOS while mask tokens remain after a position (paper App. B.2)."""
    penalty = torch.where(any_mask_after, NEG_INF, 0.0).to(logits.dtype)
    out = logits.clone()
    out[..., eos_id] += penalty
    return out
