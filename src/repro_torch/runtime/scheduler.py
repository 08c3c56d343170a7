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
  refcounted ``PageAllocator`` gates admission on the pages a request needs
  from its actual prompt length and requested blocks, maps them into the
  slot's block-table row, and takes them back when the request retires;
* **prefix page sharing** (``prefix_sharing=True``, paged): requests
  admitted in the same cycle with an identical prompt (and prompt length
  and block budget) map the first one's full prompt pages read-only.
  Attention is bidirectional, so prompt K/V depend on the whole sequence:
  greedy duplicates stay identical and share for life, while sampled ones
  diverge at their first draw, so each follower holds copy-on-write reserve
  pages from admission and the scheduler forks the shared pages onto them
  (``engine.fork_pages``) right before the first refresh after divergence;
* **the persistent prefix store** (``prefix_sharing`` with ``block_causal``,
  paged): block-causal prompt K/V depend on the prompt bytes alone, so the
  index becomes a cross-request LRU store keyed on (prompt bytes, prompt
  length).  It holds a claim on every registered prompt page, so the pages
  outlive their request; a later identical prompt, in any cycle, maps them
  (a hit, no fork and no reserve); under pool pressure ``alloc`` evicts the
  least recently used entries.  Full refreshes leave positions below
  ``core.schedule.invariant_limit`` unwritten, so shared prompt pages stay
  read-only;
* **page-aligned sparse eviction** (``sparse_attention``, paged): eviction
  is sticky, so once every row of a mapped page behind a row's current
  block is dead nothing reads or validly writes it again; after each
  refresh the scheduler unmaps such pages (``engine.dead_pages``) and
  returns them to the free list, where admission can take them at once
  (the ``pages_reclaimed`` gauge, in physical frees);
* **lazy page reservation** (``lazy_reserve=True``, paged, a finite window,
  not with preemption): admission maps the prompt and one active window of
  pages and records the rest as a deficit (``pages_deferred``); each step
  maps the next pages as a row's window reaches them.  A no-deadlock gate
  keeps the free list (plus the store's reclaimable pages) covering the
  largest deficit, and growth goes oldest first, so the oldest row always
  finishes; a younger row whose grant is denied stalls (inactive, never
  killed; ``window_stalls``) and resumes at phase 0 when pages come back.
  A request with ``max_blocks`` above its admitted budget may grow its
  extent one block at a time at its final-block entry (``blocks_grown``);
  a denial there is sticky;
* **preemption** (``preemption=True``, paged, not with sharing): a higher
  class short of pages or slots spills a strictly lower-class resident at
  its block boundary (its page bytes and row to host memory, its pages
  freed) and the victim resumes later, on its own draw keys, exactly as an
  uninterrupted run;
* **quarantine**: a row that goes non-finite is retired with a typed
  ``PoisonedRequest``, its slot reset and its private pages scrubbed before
  they return to the free list; shared pages stay intact;
* **streaming and retirement**: completed blocks go to ``Request.stream_cb``
  and the scheduler-wide callback; a finished request frees its slot and
  pages at once;
* **stats**: latency, goodput, page, sharing, store and failure gauges, the
  adaptive cache's refresh counters, and the refresh rewrites the
  block-causal exemption skipped;
* ``drain()`` with a watchdog that raises ``DrainStalled`` on zero progress.

Where the reference rebuilds its immutable state with ``.at[slot].set``, the
port writes the slot's row of the card's tensors in place.  The host reads
the card twice per step: the engine's read of which passes the step runs,
and one read of the per-row counters after it (with the dead-page report
on steps where a sparse refresh ran).  The slots' phases, which admission,
preemption and the copy-on-write fork need, and their block starts, which
window growth needs, are kept on the host from that second read; the
block tables, which only the scheduler writes, have a host copy.

Stacks with SSM layers (Mamba-2, the Jamba hybrid) serve on dense slots or
on the paged pool, with sharing and preemption, as in the reference: pages
hold the attention layers' K/V only (a pure SSM stack's pool has no plane),
and each slot keeps its own SSM caches.  A shared prompt forks K/V pages
only, every slot computing its own SSM caches; a resumed slot re-enters at
phase 0, whose prompt refresh rebuilds its SSM caches wholesale; a
quarantine scrubs K/V pages, and the next occupant's prefill rewrites the
slot's SSM caches.  The engine refuses, as the reference's does, the
adaptive cache, ``gather_refresh`` and sparse attention on such stacks.

Encoder-conditioned archs (Llama-3.2-Vision, SeamlessM4T) take
``Request.enc_embeds`` on every request, other archs on none: ``submit``
checks it both ways (``expects_enc``).  Each request is encoded once at
admission into its slot's row of ``_enc_out``, a float32 plane ``[slots,
E, d_out]`` on the engine's device, which every step passes to the engine;
the row's prefill then writes its cross planes.  A resumed request is
encoded again into its new slot, and its phase-0 refresh rebuilds the
slot's cross planes.  Prefix sharing is off for these archs, as in the
reference: their prompt K/V depend on the encoder tokens too.
SeamlessM4T's decoder has no self-attention, so its paged pool has no
K/V plane, like a pure SSM stack's.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Optional

import numpy as np
import torch

from repro_torch.configs.base import GenerationConfig
from repro_torch.core import prng
from repro_torch.core.engine import DiffusionEngine
from repro_torch.core.schedule import full_refresh_pred, invariant_limit
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
    # paged gauges: pages_in_use counts physical pages, a page shared by
    # several slots once
    pages_in_use: int = 0                # pool pages with at least one claim
    pages_total: int = 0                 # allocatable pages (excl. garbage page)
    peak_pages_in_use: int = 0
    shared_mappings: int = 0             # extra block-table claims on shared pages
    cow_forks: int = 0                   # pages copied by copy-on-write forks
    pages_reclaimed: int = 0             # pages freed early by page-aligned eviction
    resident_peak: int = 0               # max concurrently admitted requests
    early_advances: int = 0              # block advances before the aligned boundary
    # lazy reservation: far-suffix pages admission did not map up front,
    # stall events of rows whose window could not map its next pages, and
    # extent blocks granted past the admitted budget (up to max_blocks)
    pages_deferred: int = 0
    window_stalls: int = 0
    blocks_grown: int = 0
    admission_waits: list = dataclasses.field(default_factory=list)
    # adaptive feature cache: a full refresh counts refreshed == eligible, a
    # partial refresh only the tokens it recomputed
    cache_refreshed_total: int = 0
    cache_eligible_total: int = 0
    refresh_event_tokens: list = dataclasses.field(default_factory=list)
    # failure handling: a preemption spills one victim (all its pages);
    # resume_waits measures spill to re-admission
    preemptions: int = 0
    pages_spilled: int = 0
    resume_waits: list = dataclasses.field(default_factory=list)
    deadline_rejects: int = 0
    poisoned_requests: int = 0           # rows quarantined by the non-finite detector
    # the persistent prefix store (block-causal): a hit admits a request whose
    # full prompt pages were resident; an eviction drops an LRU entry under
    # pool pressure.  invariant_tokens_skipped counts the positions full
    # refreshes left unwritten (core.schedule.invariant_limit)
    prefix_hits: int = 0
    prefix_evictions: int = 0
    invariant_tokens_skipped: int = 0

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

    @property
    def resume_p50(self) -> float:
        """Median seconds a preempted request spent parked on the host."""
        return _pct(self.resume_waits, 50)

    # the names the lock-step server's stats use (BatchServer.stats)
    @property
    def tps(self) -> float:
        return self.goodput

    @property
    def requests(self) -> int:
        return self.completed

    @property
    def tokens_generated(self) -> int:
        return self.tokens_out

    def latency_pct(self, pct: float) -> float:
        return _pct(self.latencies_s, pct)

    def gauges(self) -> dict:
        """Point-in-time gauge snapshot."""
        return {name: getattr(self, name) for name in (
            "pages_in_use", "pages_total", "peak_pages_in_use", "shared_mappings",
            "cow_forks", "pages_reclaimed", "resident_peak", "early_advances",
            "pages_deferred", "window_stalls", "blocks_grown", "admission_wait_p50",
            "cache_hit_fraction", "tokens_refreshed_p50", "preemptions", "pages_spilled",
            "resume_p50", "deadline_rejects", "poisoned_requests", "prefix_hits",
            "prefix_evictions", "invariant_tokens_skipped")}


def _pct(xs: list, pct: float) -> float:
    return float(np.percentile(np.asarray(xs), pct)) if xs else 0.0


class PageAllocator:
    """Host-side refcounted free list over the shared KV pool.  Page 0 is the
    garbage page (unmapped block-table entries write to it) and is never
    handed out; pages 1..num_pages-1 are allocatable.

    ``alloc`` hands pages out at refcount 1; ``share`` adds a read-only claim
    (prefix sharing: refcount > 1 means a scatter of diverged content must
    fork the page first); ``release`` drops one claim and frees the page
    when the last one dies.  ``used_pages`` counts physical pages, a shared
    page once.  Operating on a page with no live claim raises
    ``LedgerError``.

    The allocator also keeps the same-cycle prefix index: full prompt pages
    registered under a content key at admission, so duplicates admitted in
    the same cycle map the same pages.  The scheduler clears it at the end
    of every admission cycle (bidirectional attention: pages written by
    slots admitted in different cycles are never equal).

    Persistent mode (``persistent=True``, block-causal attention only): the
    index is a cross-request store.  ``register_prefix`` takes one
    store-owned claim per page, so the pages stay resident after every slot
    claim dies; ``lookup_prefix`` is an LRU touch; ``alloc`` under pool
    pressure evicts the least recently used entries (dropping the store's
    claims only: an entry whose every page a live slot still maps would
    free nothing, and is skipped) before it reports the pool full.  The
    scheduler never clears a persistent index."""

    def __init__(self, num_pages: int, persistent: bool = False):
        if num_pages < 2:
            raise ConfigError("the pool needs the garbage page and at least one real page")
        self.num_pages = num_pages
        self.persistent = persistent
        self._free = list(range(num_pages - 1, 0, -1))   # pop() -> low ids first
        self._refcount = [0] * num_pages
        # content key -> (owner slot, [(vp, page)]); in persistent mode the
        # dict's order is the LRU order (lookup reinserts, eviction pops the front)
        self._prefix: dict = {}
        self.prefix_evictions = 0        # store entries evicted (persistent)

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def used_pages(self) -> int:
        return (self.num_pages - 1) - len(self._free)

    @property
    def shared_mappings(self) -> int:
        """Extra claims created by sharing (sum of refcount - 1 over pages)."""
        return sum(rc - 1 for rc in self._refcount if rc > 1)

    @property
    def reclaimable_pages(self) -> int:
        """Pages an eviction sweep could free now: store-claimed pages with
        no other claim.  A gate on free pages must count these beside
        ``free_pages``: the store is a cache, not a reservation."""
        if not self.persistent:
            return 0
        return sum(1 for _, page_map in self._prefix.values()
                   for _, pg in page_map if self._refcount[pg] == 1)

    def refcount(self, page: int) -> int:
        return self._refcount[page]

    def alloc(self, n: int) -> Optional[list[int]]:
        if n > len(self._free) and self.persistent:
            # pool pressure: evict least recently used entries until the
            # request fits; an entry every page of which a live slot maps
            # would free nothing and is skipped
            for key in list(self._prefix):
                if n <= len(self._free):
                    break
                _, page_map = self._prefix[key]
                if all(self._refcount[pg] > 1 for _, pg in page_map):
                    continue
                del self._prefix[key]
                self.release([pg for _, pg in page_map])
                self.prefix_evictions += 1
        if n > len(self._free):
            return None
        pages = [self._free.pop() for _ in range(n)]
        for p in pages:
            self._refcount[p] = 1
        return pages

    def _check_live(self, page: int, op: str) -> None:
        rc = self._refcount[page]
        if rc < 0:
            raise LedgerError(f"negative refcount {rc} on page {page} (ledger corrupted)")
        if rc == 0:
            verb = "double release of" if op == "release" else "share-after-free on"
            raise LedgerError(f"{verb} page {page}: no live claim")

    def share(self, pages: list[int]) -> None:
        """Adds one read-only claim per page."""
        for p in pages:
            self._check_live(p, "share")
            self._refcount[p] += 1

    def release(self, pages: list[int]) -> int:
        """Drops one claim per page; the last claim frees the page.  Returns
        the number of pages physically freed."""
        freed = 0
        for p in pages:
            self._check_live(p, "release")
            self._refcount[p] -= 1
            if self._refcount[p] == 0:
                self._free.append(p)
                freed += 1
        return freed

    def register_prefix(self, key, payload) -> None:
        """Registers ``payload = (owner slot, [(vp, page)])`` under ``key``;
        in persistent mode the store takes a claim on each page."""
        if self.persistent:
            if key in self._prefix:
                raise LedgerError("re-registering a resident prefix")
            self.share([pg for _, pg in payload[1]])
        self._prefix[key] = payload

    def lookup_prefix(self, key):
        """The payload under ``key``, or None; in persistent mode a hit
        becomes the most recently used entry."""
        hit = self._prefix.get(key)
        if hit is not None and self.persistent:
            self._prefix[key] = self._prefix.pop(key)
        return hit

    def clear_prefix_index(self) -> None:
        """Empties the index; a persistent store's claims are dropped, so
        its pages can free."""
        if self.persistent:
            for _, page_map in self._prefix.values():
                self.release([pg for _, pg in page_map])
        self._prefix.clear()

    def drop_prefix_entries(self, pages: set) -> int:
        """Drops every index entry that maps any of ``pages`` (quarantine: a
        poisoned row's pages must not stay reachable), with a persistent
        store's claims on them; returns the number of entries dropped."""
        hit = [k for k, (_, page_map) in self._prefix.items()
               if any(pg in pages for _, pg in page_map)]
        for k in hit:
            _, page_map = self._prefix.pop(k)
            if self.persistent:
                self.release([pg for _, pg in page_map])
        return len(hit)


@dataclasses.dataclass(eq=False)
class _SpilledRequest:
    """A preempted request parked on the host, captured at its block
    boundary (phase 0): the next step of both the parked and an
    uninterrupted run is a full refresh, which rebuilds the confidence,
    prediction and indicator caches from the tokens and the K/V, so only the
    fields below must survive.  It holds no allocator claim while parked."""
    req: Request
    seq: int                 # submission order (FIFO within a class on resume)
    n_blocks: int            # admission-time block budget
    vps: list                # mapped virtual pages at spill time, in order
    kv_data: tuple           # engine.spill_pages: every pool plane ((k, v), and the int8
                             # scales), one page per entry of vps
    row: dict                # the slot's per-row fields
    extent: tuple            # (first_vp, last_vp) the request may ever map
    frontier: int            # first virtual page not mapped yet
    streamed: int            # blocks already streamed
    spill_s: float           # clock at spill (resume_waits gauge)


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
        seed: int = 0,                      # base sampling key prng_key(seed)
        stream_cb: Optional[StreamCallback] = None,
        clock=time.monotonic,
        paged: bool = False,
        page_size: int = 16,
        kv_pages: Optional[int] = None,     # None => dense-equivalent pool
        prefix_sharing: bool = False,       # same-cycle prompt-page sharing (paged)
        early_advance: bool = False,        # per-row cadence: any-iteration
                                            # admission + immediate block advance
        lazy_reserve: bool = False,         # paged + window: admit with prompt + one
                                            # active window of pages, grow the rest
        preemption: bool = False,           # spill lower classes to host (paged)
        engine: Optional[DiffusionEngine] = None,   # share another scheduler's engine
        **engine_kw,
    ):
        if lazy_reserve and not paged:
            raise ConfigError("lazy_reserve defers pool pages: it requires paged=True")
        if lazy_reserve and not gen.windowed:
            raise ConfigError("lazy_reserve needs a finite window (window_blocks > 0): "
                              "unmapped far-suffix pages are sound only when the window "
                              "masks them")
        if preemption and lazy_reserve:
            raise ConfigError("preemption=True is incompatible with lazy_reserve: spills "
                              "would invalidate the max-deficit window-growth accounting")
        if prefix_sharing and not paged:
            raise ConfigError("prefix_sharing shares pool pages: it requires paged=True")
        if preemption and not paged:
            raise ConfigError("preemption=True requires paged=True: spilling moves pool "
                              "pages, dense KV rows cannot be released")
        if preemption and prefix_sharing:
            raise ConfigError("preemption=True is incompatible with prefix_sharing: a spill "
                              "releases the victim's pages, which sharing may have mapped "
                              "into co-resident slots")
        if gen.gen_length % gen.block_length:
            raise ConfigError("gen_length must be a multiple of block_length")
        self.gen = gen
        self.prompt_len = prompt_len
        self.pad_id = pad_id
        self.stream_cb = stream_cb
        self.clock = clock
        self.paged = paged
        self.page_size = page_size
        self.prefix_sharing = prefix_sharing
        # the persistent store is sound exactly under block-causal attention
        # (prompt K/V depend on the prompt bytes alone): it comes with the
        # flag pair, and bidirectional sharing keeps its same-cycle index
        self.persistent_prefix = bool(prefix_sharing and paged and gen.block_causal)
        self.preemption = preemption
        self.lazy_reserve = lazy_reserve
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
            self.allocator = PageAllocator(kv_pages, persistent=self.persistent_prefix)
        if engine is not None:
            # the sharded scheduler's lanes share one engine: everything that
            # shapes its step must agree
            if (engine.gen is not gen or engine.paged != paged
                    or (paged and engine.page_size != page_size)
                    or (paged and engine.kv_pages != kv_pages)
                    or engine.early_advance != early_advance):
                raise ConfigError("shared engine mismatch: a scheduler can only reuse an "
                                  "engine built with the same gen config and identical "
                                  "paged/page_size/kv_pages/early_advance settings")
            self.engine = engine
        else:
            self.engine = DiffusionEngine(model, gen, early_advance=early_advance, **engine_kw)
        self.device = self.engine.device
        self.n_blocks = gen.gen_length // gen.block_length
        self.state = self.engine.init_engine_state(max_slots, prompt_len, prng.prng_key(seed))
        self._phases = np.zeros((max_slots,), np.int32)   # host copy of state.phase
        # host copy of state.block_tables: the scheduler is its only writer
        self._bt = (None if self.state.block_tables is None
                    else self.state.block_tables.cpu().numpy().copy())
        self.queue: deque[Request] = deque()
        self.slot_req: list[Optional[Request]] = [None] * max_slots
        self.slot_streamed: list[int] = [0] * max_slots
        self.slot_blocks: list[int] = [0] * max_slots   # blocks this request asked for
        # one entry per page claim the slot holds (shared pages included)
        self.slot_pages: list[list[int]] = [[] for _ in range(max_slots)]
        self.slot_order: list[int] = [0] * max_slots    # admission sequence number
        # lazy reservation: the (first_vp, last_vp) a request may ever map and
        # its first unmapped virtual page (== last_vp when fully mapped);
        # no_grow freezes the extent for life (no max_blocks headroom, or a
        # denied growth: a later grant would remap pages read as masked)
        self.slot_extent: list[tuple[int, int]] = [(0, 0)] * max_slots
        self.slot_frontier: list[int] = [0] * max_slots
        self.slot_no_grow: list[bool] = [True] * max_slots
        self._admit_seq = 0
        # rows paused by a denied window growth: inactive on the card but not
        # retired; _finish_cycle skips them, _grow_windows resumes them
        self.stalled: set[int] = set()
        # preempted requests parked on the host; they compete with the queue
        # by (priority, submission order)
        self._spilled: list[_SpilledRequest] = []
        # sharing cohorts: {"owner": slot, "slots": {slot: [(vp, page)]},
        # "reserve": {slot: [pages]}, "born": step of admission}
        self.cohorts: list[dict] = []
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
        # the modality contract, checked at submit: encoder-conditioned archs
        # need enc_embeds on every request, the others on none
        cfg = self.engine.model.cfg
        self.expects_enc = bool(cfg.n_encoder_layers) or cfg.family in ("audio", "vlm")
        self._enc_out: Optional[torch.Tensor] = None
        if self.expects_enc:
            # the vision model's patch embeddings are projected to d_model
            d_out = cfg.d_model if cfg.family == "vlm" else (cfg.d_enc or cfg.d_model)
            self._enc_out = torch.zeros((max_slots, cfg.n_enc_tokens, d_out),
                                        dtype=torch.float32, device=self.device)

    # ------------------------------------------------------------------
    # submission / admission
    # ------------------------------------------------------------------
    def submit(self, req: Request) -> None:
        if (req.enc_embeds is not None) != self.expects_enc:
            raise ValueError(
                f"modality mismatch: model "
                f"{'requires' if self.expects_enc else 'does not accept'} enc_embeds but "
                f"request {req.request_id} {'omitted' if self.expects_enc else 'supplied'} them")
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
        """Fill free slots, highest priority first and FIFO within a class;
        parked (preempted) requests compete under the same order.  In paged
        mode the head waits (no overtaking) until enough pages are free, or,
        with ``preemption``, spills strictly lower classes to make room.  An
        admitted slot's phase is 0, so its next step prefills it.

        With ``lazy_reserve`` only the prompt and one active window of pages
        are mapped; the rest of the extent is a deficit that
        ``_grow_windows`` maps as the window reaches it.  The head waits
        unless the free list (with the store's reclaimable pages) still
        covers the largest deficit, its own or a resident's, after this
        admission.  A request whose ``max_blocks`` exceeds its budget has
        every block inside its first window's horizon decided here, once,
        under the same gate.

        With ``prefix_sharing`` a request's full prompt pages are indexed by
        content; a same-cycle duplicate (identical prompt bytes, prompt
        length and block budget) maps the first one's pages read-only and
        allocates only its private pages, plus, when sampling, as many
        copy-on-write reserve pages as it shares, so the fork before its
        first refresh never waits on the free list.  With the persistent
        store the key drops the block budget and a hit, in any cycle, takes
        no reserve: block-causal prompt K/V never diverge."""
        free = [i for i, r in enumerate(self.slot_req) if r is None]
        if not (self.queue or self._spilled) or (not free and not self.preemption):
            return
        st = self.state
        t_total = self.prompt_len + self.gen.gen_length
        now = self.clock()
        sampled = self.gen.temperature > 0
        cycle_cohorts: dict = {}            # share key -> cohort (this cycle only)
        while self.queue or self._spilled:
            cands = [(-r.priority, self._seq[r.request_id], r) for r in self.queue]
            cands += [(-rec.req.priority, rec.seq, rec) for rec in self._spilled]
            neg_prio, _, top = min(cands, key=lambda c: c[:2])
            if not free:
                # slot-starved: spill one lower-class victim for its slot
                if not self._try_preempt(0, -neg_prio, free):
                    break
            if isinstance(top, _SpilledRequest):
                got = self.allocator.alloc(len(top.vps))
                if got is None and self._try_preempt(len(top.vps), top.req.priority, free):
                    got = self.allocator.alloc(len(top.vps))
                if got is None:
                    break                   # page-gated: retry next step
                self._spilled.remove(top)
                self._resume_into(free.pop(0), top, got, now)
                continue
            req = top
            if req.deadline_s is not None:
                waited = now - req.arrival_s
                est = self._estimate_service_s(self._req_blocks(req))
                if waited + est > req.deadline_s:
                    self.queue.remove(req)
                    self._reject_deadline(req, waited, est)
                    continue
            n_blocks = self._req_blocks(req)
            p = np.asarray(req.prompt, np.int32)[-self.prompt_len:]
            no_grow = req.max_blocks is None
            if self.lazy_reserve and req.max_blocks is not None:
                # on-demand extent growth: the first window already attends
                # 1 + window_blocks blocks, so whether each of them exists is
                # decided here, once (a later mapping would change the row's
                # read set mid-block); blocks past it are decided one at a
                # time at their entry by _grow_windows.  A denial admits the
                # budget's extent and freezes it.
                cap = min(max(req.max_blocks, 1), self.n_blocks)
                want_nb = min(1 + self.gen.window_blocks, cap)
                if n_blocks < want_nb:
                    w_first, w_last = self._pages_needed(len(p), want_nb)
                    if self._avail() - (w_last - w_first) >= self._resident_deficit():
                        n_blocks = want_nb
                    else:
                        no_grow = True
            pages: list[int] = []
            shared_map: list[tuple[int, int]] = []    # [(vp, physical page)]
            reserve: list[int] = []
            share_key = share_hit = None
            deficit = 0
            if self.allocator is not None:
                first_vp, last_vp = self._pages_needed(len(p), n_blocks)
                map_last = last_vp
                if self.lazy_reserve:
                    # the prompt and the first window; the far suffix is a
                    # deficit (private pages only: shared prompt pages lie
                    # inside the first window)
                    init_blocks = min(1 + self.gen.window_blocks, n_blocks)
                    map_last = -(-(self.prompt_len + init_blocks * self.gen.block_length)
                                 // self.page_size)
                    deficit = last_vp - map_last
                need = map_last - first_vp
                vp0 = -(-(self.prompt_len - len(p)) // self.page_size)   # first full prompt page
                vp1 = self.prompt_len // self.page_size
                if self.prefix_sharing and not self.expects_enc and vp1 > vp0:
                    share_key = ((p.tobytes(), len(p)) if self.persistent_prefix
                                 else (p.tobytes(), len(p), n_blocks))
                    share_hit = self.allocator.lookup_prefix(share_key)
                if share_hit is not None:
                    owner_slot, owner_map = share_hit
                    shared_map = list(owner_map)
                    n_res = len(shared_map) if sampled and not self.persistent_prefix else 0
                    n_priv = need - len(shared_map)
                    # claimed before alloc: an eviction under pressure may
                    # drop this very entry, and these claims keep its pages
                    self.allocator.share([pg for _, pg in shared_map])
                    if not self._deficit_gate(n_priv + n_res, deficit):
                        self.allocator.release([pg for _, pg in shared_map])
                        break               # reserve-gated: retry next step
                    got = self.allocator.alloc(n_priv + n_res)
                    if got is None:
                        self.allocator.release([pg for _, pg in shared_map])
                        break               # page-gated: retry next step
                    pages, reserve = got[:n_priv], got[n_priv:]
                    if self.persistent_prefix:
                        self.stats.prefix_hits += 1
                else:
                    if not self._deficit_gate(need, deficit):
                        break               # reserve-gated: retry next step
                    got = self.allocator.alloc(need)
                    if got is None and self._try_preempt(need, req.priority, free):
                        got = self.allocator.alloc(need)
                    if got is None:
                        break               # page-gated: retry next step
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
            st.sample_seeds[slot] = (req.sample_seed if req.sample_seed is not None
                                     else req.request_id)
            if st.feat is not None:
                # a recycled slot must not inherit the previous request's
                # probe features, confidences or refresh counters
                st.feat[slot] = 0.0
                st.conf_full[slot] = 0.0
                st.cache_refreshed[slot] = 0
                st.cache_eligible[slot] = 0
            st.kv_valid[slot] = True
            if self.allocator is not None:
                bt_row = np.full((t_total // self.page_size,), -1, np.int32)
                shared_vps = {vp for vp, _ in shared_map}
                # under lazy_reserve [map_last, last_vp) stays unmapped for now
                bt_row[[vp for vp in range(first_vp, map_last) if vp not in shared_vps]] = pages
                for vp, pg in shared_map:
                    bt_row[vp] = pg
                self._set_bt_row(slot, bt_row)
                # one claim per mapped page; reserves are claims too, held by
                # the cohort until a fork or retirement consumes them
                self.slot_pages[slot] = pages + [pg for _, pg in shared_map]
                if share_hit is not None and not self.persistent_prefix:
                    cohort = cycle_cohorts.get(share_key)
                    if cohort is None:
                        cohort = {"owner": owner_slot, "slots": {owner_slot: list(owner_map)},
                                  "reserve": {}, "born": self.stats.steps}
                        self.cohorts.append(cohort)
                        cycle_cohorts[share_key] = cohort
                    cohort["slots"][slot] = list(shared_map)
                    if reserve:
                        cohort["reserve"][slot] = reserve
                elif share_hit is None and share_key is not None:
                    # persistent mode: the store takes its own claims, so the
                    # pages outlive this slot
                    self.allocator.register_prefix(
                        share_key, (slot, [(vp, int(bt_row[vp])) for vp in range(vp0, vp1)]))
                self.slot_extent[slot] = (first_vp, last_vp)
                self.slot_frontier[slot] = map_last
                self.slot_order[slot] = self._admit_seq
                self._admit_seq += 1
                self.stats.pages_deferred += deficit
                self._page_gauges()
            self.slot_blocks[slot] = n_blocks
            self.slot_no_grow[slot] = no_grow
            if self.expects_enc:
                self._encode_into(slot, req)
            req.admit_s = now
            self.stats.admission_waits.append(now - req.arrival_s)
            self.slot_req[slot] = req
            self.slot_streamed[slot] = 0
        if self.allocator is not None:
            if not self.persistent_prefix:
                # bidirectional attention: the index only describes this cycle
                self.allocator.clear_prefix_index()
            self.stats.shared_mappings = self.allocator.shared_mappings
            self.stats.prefix_evictions = self.allocator.prefix_evictions
            self.stats.pages_in_use = self.allocator.used_pages
        self.stats.resident_peak = max(self.stats.resident_peak,
                                       sum(r is not None for r in self.slot_req))

    def _avail(self) -> int:
        """Pages an allocation could get now: the free list and the
        persistent store's reclaimable pages (a cache, not a reservation)."""
        return self.allocator.free_pages + self.allocator.reclaimable_pages

    def _resident_deficit(self) -> int:
        """The largest deficit (extent pages not mapped yet) of a resident."""
        return max((self.slot_extent[s][1] - self.slot_frontier[s]
                    for s, r in enumerate(self.slot_req) if r is not None), default=0)

    def _deficit_gate(self, need: int, deficit: int) -> bool:
        """The lazy admission gate: after taking ``need`` pages the pool must
        still cover the largest deficit, the new request's own (``deficit``)
        or a resident's, so the oldest row can always finish growing.
        Always open without ``lazy_reserve``."""
        return (not self.lazy_reserve
                or self._avail() - need >= max(deficit, self._resident_deficit()))

    def _set_bt_row(self, slot: int, row) -> None:
        """Writes slot ``slot``'s block-table row, host copy and card."""
        self._bt[slot] = row
        self.state.block_tables[slot] = torch.from_numpy(self._bt[slot]).to(self.device)

    def _upload_bt(self) -> None:
        """Copies the host block tables onto the card's, whole."""
        self.state.block_tables.copy_(torch.from_numpy(self._bt))

    def _page_gauges(self) -> None:
        self.stats.pages_in_use = self.allocator.used_pages
        self.stats.peak_pages_in_use = max(self.stats.peak_pages_in_use,
                                           self.stats.pages_in_use)
        self.stats.shared_mappings = self.allocator.shared_mappings

    # ------------------------------------------------------------------
    # priority preemption: spill to host memory and resume
    # ------------------------------------------------------------------
    def _try_preempt(self, need: int, priority: int, free: list) -> bool:
        """Spills residents of a strictly lower class until the free list
        covers ``need`` pages (``need == 0``: until one slot is free).
        Victims are taken lowest class first and youngest first within a
        class, and only at their block boundary (phase 0), where the parked
        row's next step is the full refresh an uninterrupted run would take.
        Returns whether the need is met."""
        if not self.preemption or self.allocator is None:
            return False
        victims = [s for s, r in enumerate(self.slot_req)
                   if r is not None and r.priority < priority and s not in self.stalled
                   and self._phases[s] == 0]
        if not victims:
            return False
        victims.sort(key=lambda s: (self.slot_req[s].priority, -self.slot_order[s]))
        if need > 0 and self.allocator.free_pages + sum(
                len(self.slot_pages[s]) for s in victims) < need:
            return False                     # even spilling every victim won't fit
        now = self.clock()
        spilled_any = False
        for s in victims:
            if (need > 0 and self.allocator.free_pages >= need) or (need == 0 and spilled_any):
                break
            self._spill_slot(s, now)
            free.append(s)
            spilled_any = True
        return self.allocator.free_pages >= need if need > 0 else spilled_any

    def _spill_slot(self, slot: int, now: float) -> None:
        """Parks a resident on the host: its mapped page bytes and per-row
        fields are copied off the card, every allocator claim is released,
        and the row is deactivated and unmapped."""
        st = self.state
        req = self.slot_req[slot]
        bt = self._bt[slot]
        vps = [int(v) for v in np.nonzero(bt >= 0)[0]]
        pages = [int(bt[vp]) for vp in vps]
        counters = torch.stack([st.bs[slot], st.blocks_left[slot], st.iters[slot],
                                st.prompt_start[slot], st.sample_seeds[slot]]).tolist()
        row = dict(zip(("bs", "blocks_left", "iters", "prompt_start", "sample_seeds"),
                       counters))
        # copies: the slot's row is rewritten as soon as another request takes it
        row["tokens"] = st.tokens[slot].to("cpu", copy=True)
        row["kv_valid"] = st.kv_valid[slot].to("cpu", copy=True)
        if st.feat is not None:
            # the adaptive cache's planes carry across refreshes, so unlike
            # conf/pred/hidden they must round-trip
            for name in ("feat", "conf_full", "cache_refreshed", "cache_eligible"):
                row[name] = getattr(st, name)[slot].to("cpu", copy=True)
        self._spilled.append(_SpilledRequest(
            req=req, seq=self._seq[req.request_id], n_blocks=self.slot_blocks[slot],
            vps=vps, kv_data=self.engine.spill_pages(st, pages), row=row,
            extent=self.slot_extent[slot], frontier=self.slot_frontier[slot],
            streamed=self.slot_streamed[slot], spill_s=now))
        self.allocator.release(self.slot_pages[slot])
        self.slot_pages[slot] = []
        st.active[slot] = False
        self._set_bt_row(slot, -1)
        self.slot_req[slot] = None
        self.stats.preemptions += 1
        self.stats.pages_spilled += len(pages)
        self.stats.pages_in_use = self.allocator.used_pages

    def _resume_into(self, slot: int, rec: _SpilledRequest, got: list, now: float) -> None:
        """Re-admits a parked request: its page bytes go onto the fresh
        pages ``got``, mapped at the same virtual pages, and every per-row
        field comes back, at phase 0 and the same lifetime ``iters``, so the
        request resumes on the draw keys an uninterrupted run would use."""
        st = self.state
        self.engine.restore_pages(st, got, rec.kv_data)
        bt_row = np.full(((self.prompt_len + self.gen.gen_length) // self.page_size,), -1,
                         np.int32)
        bt_row[rec.vps] = got
        self._set_bt_row(slot, bt_row)
        for name, value in rec.row.items():
            getattr(st, name)[slot] = value.to(self.device) if torch.is_tensor(value) else value
        st.phase[slot] = 0
        self._phases[slot] = 0
        st.active[slot] = True
        st.poisoned[slot] = False
        self.slot_req[slot] = rec.req
        self.slot_blocks[slot] = rec.n_blocks
        self.slot_streamed[slot] = rec.streamed
        self.slot_pages[slot] = list(got)
        self.slot_extent[slot] = rec.extent
        self.slot_frontier[slot] = rec.frontier
        self.slot_order[slot] = self._admit_seq
        self._admit_seq += 1
        if self.expects_enc:
            # the resumed row's phase-0 refresh rebuilds its cross planes from
            # the encoder plane, which another request may have overwritten
            self._encode_into(slot, rec.req)
        self.stats.resume_waits.append(now - rec.spill_s)
        self._page_gauges()

    def _encode_into(self, slot: int, req: Request) -> None:
        """Encodes the request's ``enc_embeds`` (an array, or a tensor on any
        device) into the slot's row of the float32 encoder plane."""
        enc = torch.as_tensor(req.enc_embeds, dtype=torch.float32)[None]
        self._enc_out[slot] = self.engine.model.encode(enc)[0]

    # ------------------------------------------------------------------
    # the serving loop
    # ------------------------------------------------------------------
    def has_work(self) -> bool:
        return bool(self.queue) or bool(self._spilled) or any(
            r is not None for r in self.slot_req)

    def step(self) -> bool:
        """One engine iteration (+ bookkeeping).  Returns False and does
        nothing when there is neither queued nor resident work."""
        t0 = self.clock()           # admission work is wall time
        resident = np.asarray([r is not None for r in self.slot_req])
        if (self.queue or self._spilled) and self._phases.any() and not resident.any():
            # quarantine can retire the last resident mid-block and freeze
            # every phase off the boundary; with nobody resident the phases
            # mean nothing, but the aligned admission gate reads them
            self._phases[:] = 0
            self.state.phase.zero_()
        if self.early_advance or bool((self._phases == 0).all()):
            self._admit()
        phases = self._phases.copy()
        resident = np.asarray([r is not None for r in self.slot_req])
        if not resident.any():
            return False
        # rows whose next step is a prompt refresh, the only branch that
        # scatters into the row's prompt pages; a stalled row's phase drifts
        # while it is inactive and describes no upcoming refresh
        refresh_rows = self.engine.prompt_refresh_rows(phases) & resident
        if self.stalled:
            refresh_rows[list(self.stalled)] = False
        if self.cohorts and refresh_rows.any():
            self._cow_fork_before_refresh(refresh_rows)
        pre = self.state
        self.state = self.engine.step(pre, self._enc_out)
        # one read of the per-row counters (and, after a sparse refresh, of
        # the dead-page report): it waits for the step to finish
        host = torch.stack([pre.blocks_left, self.state.blocks_left, self.state.phase,
                            self.state.active.int(), self.state.poisoned.int(),
                            pre.cache_refreshed, self.state.cache_refreshed,
                            pre.cache_eligible, self.state.cache_eligible,
                            pre.bs, pre.iters, pre.prompt_start, self.state.bs])
        reclaim = self.paged and self.gen.sparse_attention and bool(refresh_rows.any())
        if reclaim:
            host = torch.cat([host, self.engine.dead_pages(self.state).int().T])
        host = host.cpu().numpy()
        pre_bl, bl, phase, active, poisoned = host[:5]
        if self.gen.block_causal and refresh_rows.any():
            # positions this step's full refreshes left in place, from the
            # horizon the engine's refresh token mask used
            full = np.asarray(full_refresh_pred(self.gen, host[10]), bool)
            inv = invariant_limit(self.gen, host[9], host[10], self.prompt_len)
            skipped = np.maximum(inv - host[11], 0)
            self.stats.invariant_tokens_skipped += int(skipped[refresh_rows & full].sum())
        self._phases = phase.astype(np.int32)
        self.stats.steps += 1
        dt = self.clock() - t0
        self.stats.wall_s += dt
        self._step_ewma = dt if self._step_ewma is None else 0.8 * self._step_ewma + 0.2 * dt
        d_r, d_e = host[6] - host[5], host[8] - host[7]
        self.stats.cache_refreshed_total += int(d_r.sum())
        self.stats.cache_eligible_total += int(d_e.sum())
        self.stats.refresh_event_tokens.extend(d_r[d_e > 0].tolist())
        if poisoned.any():
            # before reclaim and retirement: a poisoned row must never reach
            # the page-eviction or streaming paths
            self._quarantine([int(s) for s in np.nonzero(poisoned)[0]])
        if reclaim:
            self._reclaim_dead_pages(host[13:].T.astype(bool) & refresh_rows[:, None])
        if self.early_advance:
            steps_pb = self.gen.resolved_steps()
            adv = (bl < pre_bl) & resident
            self.stats.early_advances += int((adv & ((phases + 1) % steps_pb != 0)).sum())
            # a finished row's slot is free for the very next admission
            self._finish_cycle(bl, active)
        elif bool((phase == 0).all()):
            self._finish_cycle(bl, active)
        if self.lazy_reserve:
            # after retirement, so pages freed this step are grantable; on
            # every step, as the aligned cadence advances bs at its wrap
            self._grow_windows(host[12], bl)
        return True

    # ------------------------------------------------------------------
    # lazy reservation: window growth
    # ------------------------------------------------------------------
    def _grow_windows(self, bs: np.ndarray, blocks_left: np.ndarray) -> None:
        """Maps the pages of each resident's current window horizon (``bs +
        block_length * (1 + window_blocks)``, capped at its extent) that are
        not mapped yet, given the rows' ``bs`` and ``blocks_left`` after
        this step.

        Growth goes oldest first: a row gets its pages only if the pool
        (free plus reclaimable) still covers the deficit of every older row
        afterwards, which with the admission gate keeps the oldest row able
        to finish, so every row finishes in turn.  A denied row stalls
        (inactive on the card, never killed; ``window_stalls``) and resumes
        at phase 0 on the step its grant lands: a stall only follows a block
        advance, where the phase had wrapped to 0.

        Extent growth: a row with ``max_blocks`` above its budget, at the
        entry of its final block (its horizon first passes its extent), is
        granted one more block if the whole enlarged remaining need fits on
        top of the older rows' deficits (``blocks_grown``, its device
        ``blocks_left`` bumped); a denial is sticky (``slot_no_grow``):
        a later grant would remap pages the row already read as masked."""
        lb, ps = self.gen.block_length, self.page_size
        order = sorted((s for s, r in enumerate(self.slot_req) if r is not None),
                       key=lambda s: self.slot_order[s])
        deficit = {s: self.slot_extent[s][1] - self.slot_frontier[s] for s in order}
        st = self.state
        changed = False
        for i, slot in enumerate(order):
            frontier = self.slot_frontier[slot]
            first_vp, extent_last = self.slot_extent[slot]
            want = -(-(int(bs[slot]) + lb * (1 + self.gen.window_blocks)) // ps)
            req = self.slot_req[slot]
            older = max((deficit[s] for s in order[:i]), default=0)
            if (want > extent_last and not self.slot_no_grow[slot] and blocks_left[slot] > 0
                    and req.max_blocks is not None
                    and self.slot_blocks[slot] < min(max(req.max_blocks, 1), self.n_blocks)):
                nb = self.slot_blocks[slot] + 1
                new_last = -(-(self.prompt_len + nb * lb) // ps)
                if self._avail() - (new_last - frontier) >= older:
                    self.stats.pages_deferred += new_last - extent_last
                    self.stats.blocks_grown += 1
                    self.slot_extent[slot] = (first_vp, new_last)
                    self.slot_blocks[slot] = nb
                    deficit[slot] = new_last - frontier
                    extent_last = new_last
                    st.blocks_left[slot] += 1
                else:
                    self.slot_no_grow[slot] = True
            g = min(want, extent_last) - frontier
            if g <= 0:
                continue
            if self._avail() - g >= older:
                got = self.allocator.alloc(g)        # the gate implies it succeeds
                self._bt[slot, frontier:frontier + g] = got
                self.slot_pages[slot].extend(got)
                self.slot_frontier[slot] = frontier + g
                deficit[slot] -= g
                changed = True
                if slot in self.stalled:
                    # the phase kept ticking while the row was frozen
                    self.stalled.discard(slot)
                    st.active[slot] = True
                    st.phase[slot] = 0
                    self._phases[slot] = 0
            elif slot not in self.stalled:
                self.stalled.add(slot)
                self.stats.window_stalls += 1
                st.active[slot] = False
        if changed:
            self._upload_bt()
            self._page_gauges()

    # ------------------------------------------------------------------
    # copy-on-write
    # ------------------------------------------------------------------
    def _release_cohort_claims(self, slot: int) -> None:
        """Takes ``slot`` out of its cohort, releasing its unused reserve;
        a cohort left with one member dissolves."""
        for cohort in list(self.cohorts):
            if slot in cohort["slots"]:
                del cohort["slots"][slot]
                reserve = cohort["reserve"].pop(slot, [])
                if reserve:
                    self.allocator.release(reserve)
                if len(cohort["slots"]) <= 1:
                    self._dissolve_cohort(cohort)

    def _dissolve_cohort(self, cohort: dict) -> None:
        """Drops a cohort whose membership fell to one: its shared pages are
        the survivor's own now, so it never forks and its reserve goes back."""
        for reserve in cohort["reserve"].values():
            self.allocator.release(reserve)
        cohort["reserve"] = {}
        self.cohorts.remove(cohort)

    def _cow_fork_before_refresh(self, refresh_rows: np.ndarray) -> None:
        """An upcoming refresh scatters recomputed prompt K/V into the
        refreshing row's mapped pages.  Greedy cohorts stay identical (the
        same trajectory, so the same bytes), and share for life; sampled
        ones diverged at their first draw, so on the first step after
        admission on which any member refreshes, every follower's shared
        pages are copied onto its reserve (one ``fork_pages`` launch for all
        cohorts) and its block table repointed."""
        if self.gen.temperature <= 0:
            return
        bt = self._bt
        all_src: list[int] = []
        all_dst: list[int] = []
        for cohort in list(self.cohorts):
            if self.stats.steps <= cohort["born"]:
                continue            # the admission prefill itself: nothing drawn yet
            if not any(refresh_rows[s] for s in cohort["slots"]):
                continue
            for slot in [s for s in cohort["slots"] if s != cohort["owner"]]:
                # a reclaim may have unmapped some of the shared pages
                mapping = [(vp, pg) for vp, pg in cohort["slots"].pop(slot)
                           if bt[slot, vp] == pg]
                src = [pg for _, pg in mapping]
                reserve = cohort["reserve"].pop(slot, [])
                if len(reserve) < len(src):
                    raise LedgerError(f"slot {slot}: {len(reserve)} reserve pages for "
                                      f"{len(src)} shared pages")
                dst, spare = reserve[:len(src)], reserve[len(src):]
                for (vp, _), pg in zip(mapping, dst):
                    bt[slot, vp] = pg
                sp = self.slot_pages[slot]
                for s_pg, d_pg in zip(src, dst):
                    sp[sp.index(s_pg)] = d_pg
                self.allocator.release(src)          # drop the read-only claims
                if spare:
                    self.allocator.release(spare)
                self.stats.cow_forks += len(src)
                all_src += src
                all_dst += dst
            self._dissolve_cohort(cohort)
        if all_src:
            self.engine.fork_pages(self.state, all_src, all_dst)
            self._upload_bt()
        self.stats.shared_mappings = self.allocator.shared_mappings
        self.stats.pages_in_use = self.allocator.used_pages

    # ------------------------------------------------------------------
    # page-aligned sparse eviction
    # ------------------------------------------------------------------
    def _reclaim_dead_pages(self, dead: np.ndarray) -> None:
        """Unmaps the wholly dead pages ``dead [B, n_vp]`` (the engine's
        ``dead_pages`` of this step's refresh rows: a row's dead set changes
        only at its own refresh) of each resident and returns them to the
        free list.  ``pages_reclaimed`` counts physical frees: a shared page
        frees once, when its last sharer's claim dies; the cohorts shed the
        claims on pages their members unmapped."""
        if not dead.any():
            return
        for slot, req in enumerate(self.slot_req):
            vps = np.nonzero(dead[slot])[0] if req is not None else ()
            if len(vps) == 0:
                continue
            pages = [int(self._bt[slot, vp]) for vp in vps]
            self._bt[slot, vps] = -1
            self.stats.pages_reclaimed += self.allocator.release(pages)
            for pg in pages:
                self.slot_pages[slot].remove(pg)
            for cohort in self.cohorts:
                if slot in cohort["slots"]:
                    cohort["slots"][slot] = [(vp, pg) for vp, pg in cohort["slots"][slot]
                                             if self._bt[slot, vp] == pg]
        self._upload_bt()
        self.stats.pages_in_use = self.allocator.used_pages
        self.stats.shared_mappings = self.allocator.shared_mappings

    # ------------------------------------------------------------------
    # retirement
    # ------------------------------------------------------------------
    def _free_slot_pages(self, slot: int) -> None:
        """Releases every claim of ``slot`` (its cohort reserve included)
        and unmaps its row: a freed page may be handed out next step, and a
        stale mapping would let the idle slot write it."""
        if self.allocator is None:
            return
        if self.slot_pages[slot]:
            self.allocator.release(self.slot_pages[slot])
            self.slot_pages[slot] = []
            self._set_bt_row(slot, -1)
        self._release_cohort_claims(slot)
        self.stats.pages_in_use = self.allocator.used_pages
        self.stats.shared_mappings = self.allocator.shared_mappings

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
            # a stalled row is paused by _grow_windows, not finished
            finished = not active[slot] and slot not in self.stalled
            if done_blocks > self.slot_streamed[slot] or finished:
                if tokens is None:
                    tokens = self.state.tokens.cpu().numpy()
            for bi in range(self.slot_streamed[slot], done_blocks):
                blk = tokens[slot, self.prompt_len + bi * lb:
                             self.prompt_len + (bi + 1) * lb].copy()
                for cb in (req.stream_cb, self.stream_cb):
                    if cb is not None:
                        cb(req, bi, blk)
            self.slot_streamed[slot] = done_blocks
            if not finished:
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
            self._free_slot_pages(slot)

    def _quarantine(self, slots: list[int]) -> None:
        """Retires rows the engine's non-finite detector flagged: a typed
        ``PoisonedRequest``, the slot reset, its pages freed.  Pages the row
        held alone (refcount 1) are zeroed before they return to the free
        list, so a later owner never reads the non-finite bytes; a shared
        page is left intact (greedy sharers go non-finite together and are
        quarantined in the same sweep; sampled cohorts forked before any
        diverged write).  Co-resident rows never read the row: attention
        reads only the reader's own block table or cache row."""
        st = self.state
        now = self.clock()
        for slot in slots:
            req = self.slot_req[slot]
            if req is not None:
                req.error = PoisonedRequest(req.request_id, slot, self.stats.steps)
                req.finish_s = now
                req.latency_s = now - req.arrival_s
                self.stats.poisoned_requests += 1
                self._completed.append(req)
                self.slot_req[slot] = None
                self.stalled.discard(slot)
            if self.allocator is not None and self.slot_pages[slot]:
                private = [pg for pg in self.slot_pages[slot]
                           if self.allocator.refcount(pg) == 1]
                if private:
                    self.engine.scrub_pages(st, private)
                self.allocator.drop_prefix_entries(set(self.slot_pages[slot]))
            self._free_slot_pages(slot)
            # reset the device row: no non-finite value survives in a plane
            # a later occupant could carry over
            st.tokens[slot] = self.engine.mask_id
            st.conf[slot] = 0.0
            st.pred[slot] = 0
            for h in st.hidden:
                h[slot] = 0.0
            st.kv_valid[slot] = True
            if st.feat is not None:
                st.feat[slot] = 0.0
                st.conf_full[slot] = 0.0
            st.active[slot] = False
            st.poisoned[slot] = False
            self.slot_streamed[slot] = 0

    def drain(self, *, max_steps: Optional[int] = None,
              max_wall_s: Optional[float] = None) -> list[Request]:
        """Run until the queue, the parked requests and the slots are empty;
        returns the retired requests (read ``Request.output`` /
        ``Request.error``).  Raises ``DrainStalled`` when ``max_steps`` or
        ``max_wall_s`` runs out with work left, or after ``_drain_patience``
        steps with no progress."""
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
                len(self._spilled), s.deadline_rejects, s.poisoned_requests, s.preemptions,
                s.window_stalls)

    def _stuck_slots(self) -> list:
        phases = self.state.phase.cpu().numpy()
        bl = self.state.blocks_left.cpu().numpy()
        return [(s, r.request_id, int(phases[s]), int(bl[s]))
                for s, r in enumerate(self.slot_req) if r is not None]
