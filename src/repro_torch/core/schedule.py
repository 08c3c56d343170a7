"""Skip-stage scheduling and the within-block cadence.

A *segment* is a contiguous range of layer groups run by one
``Model.run_layers`` call; at the end of a segment with ``keep_k`` set, the
active set shrinks to the top-k rows by importance (paper Alg. 1 line 13).

The cadence functions (``prompt_refresh_pred``, ``full_refresh_pred``,
``branch_index``) and the two horizons (``window_limit``,
``invariant_limit``) are elementwise on python ints, numpy arrays and torch
tensors alike: the offline loop (a scalar phase), the serving step (a
per-row ``[B]`` phase tensor) and the scheduler's host-side hooks (numpy)
share one truth.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from repro_torch.configs.base import GenerationConfig, ModelConfig

PARTIAL, PREFILL, BLOCK_REFRESH, SKIP_DECODE = 3, 2, 1, 0


def _where(cond, a, b):
    """Elementwise select for python scalars, numpy arrays and tensors."""
    if isinstance(cond, torch.Tensor):
        return torch.where(cond, a, b)
    if isinstance(cond, np.ndarray):
        return np.where(cond, a, b)
    return a if cond else b


def _maximum(a, b: int):
    """Elementwise ``max(a, b)`` for a python scalar, numpy array or tensor."""
    if isinstance(a, torch.Tensor):
        return torch.clamp(a, min=b)
    if isinstance(a, np.ndarray):
        return np.maximum(a, b)
    return max(a, b)


def prompt_refresh_pred(gen: GenerationConfig, t):
    """Whether iteration phase ``t`` is a prompt refresh: cache init at
    ``t == 0``, plus every ``prompt_refresh_period`` iterations."""
    pp = gen.prompt_refresh_period
    r = t == 0
    if pp > 0:
        r = r | (t % pp == 0)
    return r


def full_refresh_pred(gen: GenerationConfig, iters):
    """Among scheduled prompt refreshes, which are FULL (vs PARTIAL), from the
    lifetime iteration counter ``iters`` (``block_idx * steps_per_block +
    phase``, kept across early block advances): the k-th scheduled refresh
    is full iff ``k % cache_prompt_interval == 0``, and a block's first
    iteration always is.  Every refresh is full with the cache off."""
    if not gen.adaptive_cache:
        return iters == iters
    spb = gen.resolved_steps()
    pp = gen.prompt_refresh_period
    nrb = 1 + (spb - 1) // pp if pp > 0 else 1
    ridx = (iters // spb) * nrb + ((iters % spb) // pp if pp > 0 else 0)
    return ((ridx % gen.cache_prompt_interval) == 0) | ((iters % spb) == 0)


def branch_index(gen: GenerationConfig, t, iters=None):
    """Phase -> branch: 2 = prompt refresh (full-sequence prefill), 1 = block
    refresh (all block rows computed), 0 = skip decode (the early-skip plan).
    With the adaptive cache and a lifetime ``iters``, a scheduled refresh
    that is not full (:func:`full_refresh_pred`) is 3 = partial refresh."""
    bp = gen.block_refresh_period
    block_r = (t % bp == 0) if bp > 0 else (t != t)
    refresh_br = PREFILL
    if gen.adaptive_cache and iters is not None:
        refresh_br = _where(full_refresh_pred(gen, iters), PREFILL, PARTIAL)
    return _where(prompt_refresh_pred(gen, t), refresh_br,
                  _where(block_r, BLOCK_REFRESH, SKIP_DECODE))


def window_limit(gen: GenerationConfig, bs):
    """Exclusive attention horizon of the sliding active window for rows
    whose current block starts at ``bs``: they attend positions ``< bs +
    block_length * (1 + window_blocks)``, the block and ``window_blocks``
    blocks of masked suffix beyond it.  None when ``window_blocks == 0``
    (no window), so every caller leaves the clamp out."""
    if not gen.windowed:
        return None
    return bs + gen.block_length * (1 + gen.window_blocks)


def invariant_limit(gen: GenerationConfig, bs, iters, gen_start: int):
    """Exclusive write horizon of a full refresh under block-causal
    attention: positions below it already hold their final K/V, so the
    refresh may leave them unwritten.  A position's K/V depend only on the
    tokens at or before its own block, so the prompt is final after the
    first prefill and a settled block once the next block's entry refresh
    wrote it: the horizon is ``max(bs - block_length, gen_start)``, and 0
    on a row's first iteration (``iters == 0``).  None without
    ``block_causal``, so every caller leaves the token mask out.  The
    engine's refresh token mask and the scheduler's
    ``invariant_tokens_skipped`` gauge both come from here."""
    if not gen.block_causal:
        return None
    return _where(iters > 0, _maximum(bs - gen.block_length, gen_start), 0)


@dataclasses.dataclass(frozen=True)
class Segment:
    group_lo: int
    group_hi: int
    keep_k: int | None      # None = no skipping at this boundary
    stage_idx: int | None   # index into the hidden-cache tuple


def resolve_segments(
    cfg: ModelConfig,
    gen: GenerationConfig,
    block_len: int,
) -> tuple[list[Segment], list[int]]:
    """Returns (segments, active_sizes) where active_sizes[i] is the number
    of active rows *entering* segment i (active_sizes[0] == block_len)."""
    period = cfg.pattern_period
    n_groups = cfg.n_layers // period

    boundaries: dict[int, float] = {}
    if n_groups >= 2:
        for st in gen.skip_stages:
            grp = max(1, min(n_groups - 1, round(st.layer / period)))
            # compound ratios if two stages land on the same group boundary
            prev = boundaries.get(grp, 0.0)
            boundaries[grp] = 1.0 - (1.0 - prev) * (1.0 - st.ratio)

    segments: list[Segment] = []
    active_sizes: list[int] = []
    size = block_len
    lo = 0
    for stage_idx, grp in enumerate(sorted(boundaries)):
        keep = max(1, int(math.ceil(size * (1.0 - boundaries[grp]))))
        segments.append(Segment(lo, grp, keep, stage_idx))
        active_sizes.append(size)
        size = keep
        lo = grp
    segments.append(Segment(lo, n_groups, None, None))
    active_sizes.append(size)
    return segments, active_sizes
