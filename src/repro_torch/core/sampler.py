"""Confidence and prediction, unmasking policy and premature-EOS guard.

Temperature 0 is LLaDA's argmax with low-confidence remasking (and optional
Fast-dLLM parallel decoding); above it, Dream's sampling with top-k/top-p
filtering draws with the reference's per-row threefry keys (``core.prng``),
so the port samples the reference's tokens.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import GenerationConfig
from repro_torch.core import prng

NEG_INF = -1e30


def _mask_invalid_vocab(logits: torch.Tensor, vocab_size: int, mask_id: int) -> torch.Tensor:
    """Disallow pad-vocab rows and the [mask] token itself."""
    ids = torch.arange(logits.shape[-1], device=logits.device)
    bad = (ids >= vocab_size) | (ids == mask_id)
    return torch.where(bad, NEG_INF, logits)


def confidence_and_pred(
    keys: Optional[torch.Tensor],   # [B, 2] per-row draw keys (unused at temperature 0)
    logits: torch.Tensor,           # [B, K, V]
    gen: GenerationConfig,
    vocab_size: int,
    mask_id: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (conf [B, K] f32, the probability of the chosen token, and
    pred [B, K] int32, the chosen token).  Greedy picks the first-index
    argmax of the f32 softmax.  Sampled, row ``b`` draws its ``[K, V]``
    Gumbel noise with ``keys[b]`` over the logits divided by the temperature,
    after top-k and top-p (the smallest set whose cumulative probability
    reaches ``top_p``) set the rest to -1e30."""
    logits = _mask_invalid_vocab(logits.float(), vocab_size, mask_id)
    probs = torch.softmax(logits, dim=-1)
    if gen.temperature <= 0.0:
        pred = torch.argmax(probs, dim=-1)
        return torch.amax(probs, dim=-1), pred.to(torch.int32)
    filtered = logits / gen.temperature
    if gen.top_k > 0:
        kth = torch.topk(filtered, gen.top_k, dim=-1).values[..., -1:]
        filtered = torch.where(filtered < kth, NEG_INF, filtered)
    if gen.top_p < 1.0:
        sorted_logits = torch.sort(filtered, dim=-1, descending=True).values
        cum = torch.cumsum(torch.softmax(sorted_logits, dim=-1), dim=-1)
        # an index past the end (every prefix short of top_p by rounding)
        # keeps everything, as the reference's out-of-range gather does
        cutoff_idx = (cum < gen.top_p).sum(dim=-1, keepdim=True).clamp(max=cum.shape[-1] - 1)
        cutoff = torch.gather(sorted_logits, -1, cutoff_idx)
        filtered = torch.where(filtered < cutoff, NEG_INF, filtered)
    pred = prng.categorical(keys, filtered)
    conf = torch.gather(probs, -1, pred[..., None])[..., 0]
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
