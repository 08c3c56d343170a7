"""Continuous-batching scheduler of the port over the slot-based engine state.

The counterpart of the reference's ``repro.runtime.scheduler``: it drives
``DiffusionEngine.step`` (one denoising iteration for every resident slot)
and does all control flow on the host:

* **admission** from a queue, highest ``Request.priority`` first and FIFO
  within a class.  With ``early_advance=True`` a free slot is filled on any
  iteration (it enters at phase 0, so its next step prefills it while the
  other slots keep decoding); otherwise only when every slot sits at phase 0.
  A request with ``deadline_s`` that cannot finish in time, given the
  measured per-step cost, is retired with ``DeadlineUnmeetable``;
* **paged KV** (``paged=True``): the engine's caches are one page pool; the
  ``PageAllocator`` gates admission on the pages a request needs from its
  actual prompt length and requested blocks, maps them into the slot's
  block-table row, and takes them back when the request retires;
* **streaming and retirement**: completed blocks go to ``Request.stream_cb``
  and the scheduler-wide callback; a finished request frees its slot and
  pages at once;
* **stats**: latency, goodput, page gauges and the adaptive cache's
  refresh counters;
* ``drain()`` with a watchdog that raises ``DrainStalled`` on zero progress.

Where the reference rebuilds its immutable state with ``.at[slot].set``, the
port writes the slot's row of the card's tensors in place.  The host reads
the card twice per step: the engine's read of which passes the step runs,
and one read of the per-row counters after it.  The slots' phases, which
admission needs, are kept on the host from that second read.

Outside this slice (each raises ``ConfigError`` or ``NotImplementedError`` at
construction, see ROADMAP.md): prefix sharing and its copy-on-write fork,
preemption, lazy page reservation, and sampling.  A request whose row goes
non-finite raises ``PoisonedRequest`` from ``step`` (the reference
quarantines it).
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Optional

import numpy as np
import torch

from repro_torch.configs.base import GenerationConfig
from repro_torch.core.engine import DiffusionEngine
from repro_torch.models.model import Model
from repro_torch.runtime.errors import (
    ConfigError,
    DeadlineUnmeetable,
    DrainStalled,
    LedgerError,
    PoisonedRequest,
)
from repro_torch.runtime.request import Request, StreamCallback


@dataclasses.dataclass
class SchedulerStats:
    submitted: int = 0
    completed: int = 0
    tokens_out: int = 0
    steps: int = 0                       # engine steps run
    wall_s: float = 0.0                  # serving-loop wall: admission + engine.step
    latencies_s: list = dataclasses.field(default_factory=list)
    pages_in_use: int = 0                # paged: pool pages held by resident requests
    pages_total: int = 0                 # allocatable pages (excl. garbage page)
    peak_pages_in_use: int = 0
    resident_peak: int = 0               # max concurrently admitted requests
    early_advances: int = 0              # block advances before the aligned boundary
    admission_waits: list = dataclasses.field(default_factory=list)
    # adaptive feature cache: a full refresh counts refreshed == eligible, a
    # partial refresh only the tokens it recomputed
    cache_refreshed_total: int = 0
    cache_eligible_total: int = 0
    refresh_event_tokens: list = dataclasses.field(default_factory=list)
    deadline_rejects: int = 0

    @property
    def goodput(self) -> float:
        """Completed tokens per wall second (aggregate serving metric)."""
        return self.tokens_out / self.wall_s if self.wall_s else 0.0

    @property
    def admission_wait_p50(self) -> float:
        return _pct(self.admission_waits, 50)

    @property
    def cache_hit_fraction(self) -> float:
        """Fraction of eligible past-token K/V recomputations the adaptive
        cache skipped (0.0 when it is off or before any refresh)."""
        if not self.cache_eligible_total:
            return 0.0
        return 1.0 - self.cache_refreshed_total / self.cache_eligible_total

    @property
    def tokens_refreshed_p50(self) -> float:
        return _pct(self.refresh_event_tokens, 50)

    def latency_pct(self, pct: float) -> float:
        return _pct(self.latencies_s, pct)


def _pct(xs: list, pct: float) -> float:
    return float(np.percentile(np.asarray(xs), pct)) if xs else 0.0


class PageAllocator:
    """Host-side free list over the shared KV pool.  Page 0 is the garbage
    page (unmapped block-table entries write to it) and is never handed out;
    pages 1..num_pages-1 are allocatable.  Each page carries one claim while
    allocated; releasing a page without a claim raises ``LedgerError``."""

    def __init__(self, num_pages: int):
        if num_pages < 2:
            raise ConfigError("the pool needs the garbage page and at least one real page")
        self.num_pages = num_pages
        self._free = list(range(num_pages - 1, 0, -1))   # pop() -> low ids first
        self._claimed = [False] * num_pages

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def used_pages(self) -> int:
        return (self.num_pages - 1) - len(self._free)

    def alloc(self, n: int) -> Optional[list[int]]:
        if n > len(self._free):
            return None
        pages = [self._free.pop() for _ in range(n)]
        for p in pages:
            self._claimed[p] = True
        return pages

    def release(self, pages: list[int]) -> None:
        for p in pages:
            if not self._claimed[p]:
                raise LedgerError(f"double release of page {p}: no live claim")
            self._claimed[p] = False
            self._free.append(p)


class StreamScheduler:
    """Slot-recycling streaming scheduler (continuous batching)."""

    def __init__(
        self,
        model: Model,
        gen: GenerationConfig,
        *,
        max_slots: int = 8,
        prompt_len: int = 64,
        pad_id: int = 0,
        stream_cb: Optional[StreamCallback] = None,
        clock=time.monotonic,
        paged: bool = False,
        page_size: int = 16,
        kv_pages: Optional[int] = None,     # None => dense-equivalent pool
        early_advance: bool = False,        # per-row cadence: any-iteration
                                            # admission + immediate block advance
        prefix_sharing: bool = False,
        lazy_reserve: bool = False,
        preemption: bool = False,
        **engine_kw,
    ):
        for flag, what in ((prefix_sharing, "prefix_sharing (and its copy-on-write fork)"),
                           (lazy_reserve, "lazy_reserve"), (preemption, "preemption")):
            if flag:
                raise ConfigError(f"{what} is outside this slice of the port (ROADMAP.md)")
        if gen.gen_length % gen.block_length:
            raise ConfigError("gen_length must be a multiple of block_length")
        self.gen = gen
        self.prompt_len = prompt_len
        self.pad_id = pad_id
        self.stream_cb = stream_cb
        self.clock = clock
        self.paged = paged
        self.page_size = page_size
        self.early_advance = early_advance
        t_total = prompt_len + gen.gen_length
        self.allocator: Optional[PageAllocator] = None
        if paged:
            if t_total % page_size:
                raise ConfigError(f"page_size {page_size} must divide prompt+gen {t_total}")
            n_vp = t_total // page_size
            if kv_pages is None:
                kv_pages = max_slots * n_vp + 1
            if kv_pages <= n_vp:
                raise ConfigError("pool too small: a full-length request could never be "
                                  "admitted")
            engine_kw.update(paged=True, page_size=page_size, kv_pages=kv_pages)
            self.allocator = PageAllocator(kv_pages)
        self.engine = DiffusionEngine(model, gen, early_advance=early_advance, **engine_kw)
        self.device = self.engine.device
        self.n_blocks = gen.gen_length // gen.block_length
        self.state = self.engine.init_engine_state(max_slots, prompt_len)
        self._phases = np.zeros((max_slots,), np.int32)   # host copy of state.phase
        self.queue: deque[Request] = deque()
        self.slot_req: list[Optional[Request]] = [None] * max_slots
        self.slot_streamed: list[int] = [0] * max_slots
        self.slot_blocks: list[int] = [0] * max_slots   # blocks this request asked for
        self.slot_pages: list[list[int]] = [[] for _ in range(max_slots)]
        self._submit_seq = 0
        self._seq: dict[int, int] = {}      # request_id -> submission seq
        # measured per-step wall (EWMA): the deadline admission estimate
        self._step_ewma: Optional[float] = None
        # zero-progress watchdog bound for drain(): several full offline
        # passes' worth of iterations, so only a real livelock trips it
        self._drain_patience = max(64, 8 * gen.resolved_steps() * (self.n_blocks + 2))
        self.stats = SchedulerStats()
        if self.allocator is not None:
            self.stats.pages_total = self.allocator.num_pages - 1
        self._completed: list[Request] = []

    # ------------------------------------------------------------------
    # submission / admission
    # ------------------------------------------------------------------
    def submit(self, req: Request) -> None:
        if req.enc_embeds is not None:
            raise ValueError(f"modality mismatch: model does not accept enc_embeds but "
                             f"request {req.request_id} supplied them")
        req.arrival_s = self.clock()
        self.stats.submitted += 1
        self._seq[req.request_id] = self._submit_seq
        self._submit_seq += 1
        if req.deadline_s is not None:
            est = self._estimate_service_s(self._req_blocks(req))
            if req.deadline_s <= 0 or est > req.deadline_s:
                self._reject_deadline(req, 0.0, est)
                return
        self.queue.append(req)

    def _req_blocks(self, req: Request) -> int:
        """Admission-time block budget: ``max_new_tokens`` in whole blocks,
        capped by ``max_blocks``."""
        n_blocks = self.n_blocks
        if req.max_new_tokens is not None:
            n_blocks = min(max(-(-req.max_new_tokens // self.gen.block_length), 1),
                           self.n_blocks)
        if req.max_blocks is not None:
            n_blocks = min(n_blocks, max(req.max_blocks, 1))
        return n_blocks

    def _estimate_service_s(self, n_blocks: int) -> float:
        """Blocks x steps per block x the measured per-step wall; 0.0 until
        the first step has been timed."""
        if self._step_ewma is None:
            return 0.0
        return n_blocks * self.gen.resolved_steps() * self._step_ewma

    def _reject_deadline(self, req: Request, waited: float, est: float) -> None:
        now = self.clock()
        req.error = DeadlineUnmeetable(req.request_id, req.deadline_s, waited, est)
        req.finish_s = now
        req.latency_s = now - req.arrival_s
        self.stats.deadline_rejects += 1
        self._completed.append(req)

    def _pages_needed(self, prompt_tokens: int, n_blocks: int) -> tuple[int, int]:
        """(first_vp, last_vp) of the virtual pages a request maps, from its
        actual prompt length: whole pad-only pages below ``prompt_start`` are
        never mapped, nor pages past its last block.  So a paged
        ``max_new_tokens`` request decodes as an offline run with
        ``gen_length = n_blocks * block_length``, while dense serving attends
        the whole padded tail (the reference's layout contract)."""
        ps = self.page_size
        first_vp = (self.prompt_len - prompt_tokens) // ps
        last_vp = -(-(self.prompt_len + n_blocks * self.gen.block_length) // ps)
        return first_vp, last_vp

    def _admit(self) -> None:
        """Fill free slots from the queue, highest priority first and FIFO
        within a class; in paged mode the head waits (no overtaking) until
        retirements return enough pages.  An admitted slot's phase is 0, so
        its next step prefills it."""
        free = [i for i, r in enumerate(self.slot_req) if r is None]
        st = self.state
        t_total = self.prompt_len + self.gen.gen_length
        now = self.clock()
        while self.queue and free:
            req = min(self.queue, key=lambda r: (-r.priority, self._seq[r.request_id]))
            if req.deadline_s is not None:
                waited = now - req.arrival_s
                est = self._estimate_service_s(self._req_blocks(req))
                if waited + est > req.deadline_s:
                    self.queue.remove(req)
                    self._reject_deadline(req, waited, est)
                    continue
            n_blocks = self._req_blocks(req)
            p = np.asarray(req.prompt, np.int32)[-self.prompt_len:]
            pages: list[int] = []
            if self.allocator is not None:
                first_vp, last_vp = self._pages_needed(len(p), n_blocks)
                got = self.allocator.alloc(last_vp - first_vp)
                if got is None:
                    break                   # page-gated: retry next step
                pages = got
            slot = free.pop(0)
            self.queue.remove(req)
            row = np.full((t_total,), self.engine.mask_id, np.int32)
            row[: self.prompt_len] = self.pad_id
            row[self.prompt_len - len(p): self.prompt_len] = p
            st.tokens[slot] = torch.from_numpy(row).to(self.device)
            st.bs[slot] = self.prompt_len
            st.blocks_left[slot] = n_blocks
            st.phase[slot] = 0
            self._phases[slot] = 0
            st.iters[slot] = 0
            st.active[slot] = True
            st.prompt_start[slot] = self.prompt_len - len(p) if self.paged else 0
            if st.feat is not None:
                # a recycled slot must not inherit the previous request's
                # probe features, confidences or refresh counters
                st.feat[slot] = 0.0
                st.conf_full[slot] = 0.0
                st.cache_refreshed[slot] = 0
                st.cache_eligible[slot] = 0
            if self.allocator is not None:
                bt_row = np.full((t_total // self.page_size,), -1, np.int32)
                bt_row[first_vp:last_vp] = pages
                st.block_tables[slot] = torch.from_numpy(bt_row).to(self.device)
                self.slot_pages[slot] = pages
                self._page_gauges()
            self.slot_blocks[slot] = n_blocks
            req.admit_s = now
            self.stats.admission_waits.append(now - req.arrival_s)
            self.slot_req[slot] = req
            self.slot_streamed[slot] = 0
        self.stats.resident_peak = max(self.stats.resident_peak,
                                       sum(r is not None for r in self.slot_req))

    def _page_gauges(self) -> None:
        self.stats.pages_in_use = self.allocator.used_pages
        self.stats.peak_pages_in_use = max(self.stats.peak_pages_in_use,
                                           self.stats.pages_in_use)

    # ------------------------------------------------------------------
    # the serving loop
    # ------------------------------------------------------------------
    def has_work(self) -> bool:
        return bool(self.queue) or any(r is not None for r in self.slot_req)

    def step(self) -> bool:
        """One engine iteration (+ bookkeeping).  Returns False and does
        nothing when there is neither queued nor resident work."""
        t0 = self.clock()           # admission work is wall time
        if self.early_advance or bool((self._phases == 0).all()):
            self._admit()
        phases = self._phases.copy()
        resident = np.asarray([r is not None for r in self.slot_req])
        if not resident.any():
            return False
        pre = self.state
        self.state = self.engine.step(pre)
        # one read of the per-row counters: it waits for the step to finish
        host = torch.stack([pre.blocks_left, self.state.blocks_left, self.state.phase,
                            self.state.active.int(), self.state.poisoned.int(),
                            pre.cache_refreshed, self.state.cache_refreshed,
                            pre.cache_eligible, self.state.cache_eligible]).cpu().numpy()
        pre_bl, bl, phase, active, poisoned = host[:5]
        self._phases = phase.astype(np.int32)
        self.stats.steps += 1
        dt = self.clock() - t0
        self.stats.wall_s += dt
        self._step_ewma = dt if self._step_ewma is None else 0.8 * self._step_ewma + 0.2 * dt
        d_r, d_e = host[6] - host[5], host[8] - host[7]
        self.stats.cache_refreshed_total += int(d_r.sum())
        self.stats.cache_eligible_total += int(d_e.sum())
        self.stats.refresh_event_tokens.extend(d_r[d_e > 0].tolist())
        for slot in np.nonzero(poisoned)[0]:
            req = self.slot_req[slot]
            raise PoisonedRequest(-1 if req is None else req.request_id, int(slot),
                                  self.stats.steps)
        if self.early_advance:
            steps_pb = self.gen.resolved_steps()
            adv = (bl < pre_bl) & resident
            self.stats.early_advances += int((adv & ((phases + 1) % steps_pb != 0)).sum())
            # a finished row's slot is free for the very next admission
            self._finish_cycle(bl, active)
        elif bool((phase == 0).all()):
            self._finish_cycle(bl, active)
        return True

    def _finish_cycle(self, blocks_left: np.ndarray, active: np.ndarray) -> None:
        """Stream newly completed blocks, retire finished requests, recycle
        their slots and pages."""
        tokens = None
        lb = self.gen.block_length
        now = self.clock()
        for slot, req in enumerate(self.slot_req):
            if req is None:
                continue
            done_blocks = self.slot_blocks[slot] - int(blocks_left[slot])
            if done_blocks > self.slot_streamed[slot] or not active[slot]:
                if tokens is None:
                    tokens = self.state.tokens.cpu().numpy()
            for bi in range(self.slot_streamed[slot], done_blocks):
                blk = tokens[slot, self.prompt_len + bi * lb:
                             self.prompt_len + (bi + 1) * lb].copy()
                for cb in (req.stream_cb, self.stream_cb):
                    if cb is not None:
                        cb(req, bi, blk)
            self.slot_streamed[slot] = done_blocks
            if active[slot]:
                continue
            n_tok = self.slot_blocks[slot] * lb
            req.output = tokens[slot, self.prompt_len: self.prompt_len + n_tok].copy()
            req.finish_s = now
            req.latency_s = now - req.arrival_s
            self.stats.completed += 1
            self.stats.tokens_out += n_tok
            self.stats.latencies_s.append(req.latency_s)
            self._completed.append(req)
            self.slot_req[slot] = None
            if self.allocator is not None:
                # unmap the slot's row: a freed page may be handed out next
                # step, and a stale mapping would let the idle slot write it
                self.allocator.release(self.slot_pages[slot])
                self.slot_pages[slot] = []
                self.state.block_tables[slot] = -1
                self.stats.pages_in_use = self.allocator.used_pages

    def drain(self, *, max_steps: Optional[int] = None,
              max_wall_s: Optional[float] = None) -> list[Request]:
        """Run until the queue and the slots are empty; returns the retired
        requests (read ``Request.output`` / ``Request.error``).  Raises
        ``DrainStalled`` when ``max_steps`` or ``max_wall_s`` runs out with
        work left, or after ``_drain_patience`` steps with no progress."""
        t_start = self.clock()
        steps = idle = 0
        snap = self._progress_snapshot()
        while self.has_work():
            if max_steps is not None and steps >= max_steps:
                raise DrainStalled(f"max_steps={max_steps} exhausted with work remaining",
                                   self._stuck_slots())
            if max_wall_s is not None and self.clock() - t_start > max_wall_s:
                raise DrainStalled(f"max_wall_s={max_wall_s} exceeded with work remaining",
                                   self._stuck_slots())
            self.step()
            steps += 1
            nxt = self._progress_snapshot()
            idle = idle + 1 if nxt == snap else 0
            snap = nxt
            if idle >= self._drain_patience:
                raise DrainStalled(f"no forward progress in {idle} consecutive steps",
                                   self._stuck_slots())
        done, self._completed = self._completed, []
        return done

    def _progress_snapshot(self) -> tuple:
        """Everything the watchdog accepts as forward progress."""
        s = self.stats
        return (s.completed, s.tokens_out, tuple(self.slot_streamed),
                sum(r is not None for r in self.slot_req), len(self.queue),
                s.deadline_rejects)

    def _stuck_slots(self) -> list:
        phases = self.state.phase.cpu().numpy()
        bl = self.state.blocks_left.cpu().numpy()
        return [(s, r.request_id, int(phases[s]), int(bl[s]))
                for s, r in enumerate(self.slot_req) if r is not None]
