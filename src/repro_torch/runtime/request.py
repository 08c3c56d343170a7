"""Serving-side request objects and batch assembly: a copy of the reference's
``repro.runtime.request``, which the port cannot import (importing it runs
``repro/runtime/__init__.py`` and so the JAX scheduler)."""
from __future__ import annotations

import dataclasses
import itertools
from typing import Callable, Optional

import numpy as np

_ids = itertools.count()

# streaming callback: cb(request, block_index, block_tokens [Lb] int32)
StreamCallback = Callable[["Request", int, np.ndarray], None]


@dataclasses.dataclass(eq=False)           # identity equality: value eq would
                                           # compare ndarray fields elementwise
                                           # (queue removal, membership tests)
class Request:
    prompt: np.ndarray                     # [P] int32 token ids
    enc_embeds: Optional[np.ndarray] = None
    request_id: int = dataclasses.field(default_factory=lambda: next(_ids))
    stream_cb: Optional[StreamCallback] = None   # per-block streaming hook
    max_new_tokens: Optional[int] = None   # cap (rounded up to whole blocks);
                                           # honoured by StreamScheduler only —
                                           # the lock-step server always runs
                                           # the full gen_length
    sample_seed: Optional[int] = None      # per-request sampling seed (fold_in
                                           # index); defaults to request_id —
                                           # replay offline via
                                           # generate(sample_seeds=[seed])
                                           # (paged + max_new_tokens: replay
                                           # with the truncated gen_length —
                                           # see StreamScheduler._pages_needed)
    priority: int = 0                      # admission class: higher admits
                                           # first (FIFO within a class) and
                                           # may preempt lower classes when
                                           # the scheduler runs with
                                           # preemption=True
    deadline_s: Optional[float] = None     # SLO budget measured from
                                           # arrival; admission rejects the
                                           # request with a typed
                                           # DeadlineUnmeetable once
                                           # wait + estimated service
                                           # exceeds it
    max_blocks: Optional[int] = None       # HARD cap on generated blocks,
                                           # distinct from the soft
                                           # max_new_tokens/req_blocks hint:
                                           # under lazy reservation the hint
                                           # sizes the deficit accounting
                                           # while max_blocks bounds how far
                                           # the window may ever grow (the
                                           # SLO-aware admission hook,
                                           # ROADMAP item 5)
    # filled by the server / scheduler
    output: Optional[np.ndarray] = None
    error: Optional[Exception] = None      # typed retirement verdict
                                           # (DeadlineUnmeetable /
                                           # PoisonedRequest); None on
                                           # successful completion
    latency_s: float = 0.0                 # finish - arrival (queueing incl.)
    arrival_s: float = 0.0                 # set at submit()
    admit_s: float = 0.0                   # set when a slot is assigned
    finish_s: float = 0.0                  # set when the last block completes

    @property
    def service_s(self) -> float:
        """Time actually resident in a slot (excludes queueing delay)."""
        return max(self.finish_s - self.admit_s, 0.0)

    def tps(self) -> float:
        n = 0 if self.output is None else int(self.output.shape[0])
        return n / self.service_s if self.service_s > 0 else 0.0


def pad_and_stack(requests: list[Request], pad_id: int, prompt_len: int) -> np.ndarray:
    """Left-pad prompts to a common length and stack to [B, P]."""
    out = np.full((len(requests), prompt_len), pad_id, np.int32)
    for i, r in enumerate(requests):
        p = r.prompt[-prompt_len:]
        out[i, prompt_len - len(p):] = p
    return out
