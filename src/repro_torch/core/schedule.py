"""Skip-stage scheduling and the within-block cadence.

A *segment* is a contiguous range of layer groups run by one
``Model.run_layers`` call; at the end of a segment with ``keep_k`` set, the
active set shrinks to the top-k rows by importance (paper Alg. 1 line 13).
``prompt_refresh_pred`` and ``branch_index`` map the offline loop's phase
(a python int) to its branch.
"""
from __future__ import annotations

import dataclasses
import math

from repro_torch.configs.base import GenerationConfig, ModelConfig

PREFILL, BLOCK_REFRESH, SKIP_DECODE = 2, 1, 0


def prompt_refresh_pred(gen: GenerationConfig, t: int) -> bool:
    """Whether iteration phase ``t`` is a prompt refresh: cache init at
    ``t == 0``, plus every ``prompt_refresh_period`` iterations."""
    pp = gen.prompt_refresh_period
    return t == 0 or (pp > 0 and t % pp == 0)


def branch_index(gen: GenerationConfig, t: int) -> int:
    """Phase -> branch: 2 = prompt refresh (full-sequence prefill), 1 = block
    refresh (all block rows computed), 0 = skip decode (the early-skip plan)."""
    if prompt_refresh_pred(gen, t):
        return PREFILL
    bp = gen.block_refresh_period
    return BLOCK_REFRESH if bp > 0 and t % bp == 0 else SKIP_DECODE


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
