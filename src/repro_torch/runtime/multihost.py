"""Sharded serving of the port: the counterpart of the reference's
``repro.runtime.multihost``.

``ShardedStreamScheduler`` runs H independent *lanes*, one full
``StreamScheduler`` per shard with its own page ledger, slot planes and
drain watchdog, behind one submit queue with a placement policy:

* **shard-local ledgers**: each lane owns a private ``PageAllocator``, so
  every single-scheduler ledger invariant holds per shard, plus one law
  across shards, page conservation (``ShardedPageAllocator``);
* **placement, not migration**: a request goes to one shard at submit and
  stays there (preemption, quarantine and deadline verdicts are lane-local),
  so each shard's outputs equal a single-shard replay of its trace with the
  lane's seed ``seed + s``;
* **placements**: ``least_loaded`` (committed pages, then queue depth, then
  the shard index), ``prefix_affinity`` (the shard whose persistent prefix
  store holds the prompt, else least loaded) and ``disagg`` (the first
  ``refresh_shards`` lanes take prompts longer than ``decode_prompt_len``
  at the full ``prompt_len``, the others the short ones at the short
  width, so a long prefill does not widen the decode lanes' steps).

Lanes on the model's device share the model and one ``DiffusionEngine``
(the scheduler's ``engine=``); the engine's step takes its widths from the
state, so disagg lanes of two prompt widths share it too.  ``devices``:
``"auto"`` puts shard ``s`` on CUDA device ``s`` when the model is on the
card and ``torch.cuda.device_count() >= shards``, else every lane on the
model's device; ``None`` keeps every lane on the model's device; a list
names one device per shard.  A lane on another device gets its own copy of
the model and its own engine, and its steps run under that device's guard.
An encoder arch's lanes each own their encoder plane (``_enc_out``): a
request's ``enc_embeds`` travel with it to the lane it is placed on, which
encodes them at admission.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.configs.base import GenerationConfig
from repro_torch.models.model import Model
from repro_torch.runtime.errors import ConfigError, DrainStalled, LedgerError
from repro_torch.runtime.request import Request, StreamCallback
from repro_torch.runtime.scheduler import PageAllocator, SchedulerStats, StreamScheduler

PLACEMENTS = ("least_loaded", "prefix_affinity", "disagg")


class ShardedPageAllocator:
    """Read-only sums over H shard-local page ledgers.  Allocation always
    goes through a lane's own ``PageAllocator``; this view adds the gauges
    and checks the one law across shards: page conservation."""

    def __init__(self, lanes: list[PageAllocator]):
        self._lanes = list(lanes)

    def shard(self, s: int) -> PageAllocator:
        return self._lanes[s]

    def __len__(self) -> int:
        return len(self._lanes)

    @property
    def num_pages(self) -> int:
        return sum(a.num_pages for a in self._lanes)

    @property
    def capacity(self) -> int:
        """Allocatable pages (each lane leaves out its own garbage page)."""
        return sum(a.num_pages - 1 for a in self._lanes)

    @property
    def free_pages(self) -> int:
        return sum(a.free_pages for a in self._lanes)

    @property
    def used_pages(self) -> int:
        return sum(a.used_pages for a in self._lanes)

    @property
    def reclaimable_pages(self) -> int:
        return sum(a.reclaimable_pages for a in self._lanes)

    @property
    def shared_mappings(self) -> int:
        return sum(a.shared_mappings for a in self._lanes)

    @property
    def prefix_evictions(self) -> int:
        return sum(a.prefix_evictions for a in self._lanes)

    def check_conservation(self) -> None:
        """used + free == capacity, per shard and summed over shards: a page
        can neither move between shards nor vanish."""
        for s, a in enumerate(self._lanes):
            if a.used_pages + a.free_pages != a.num_pages - 1:
                raise LedgerError(f"shard {s}: used {a.used_pages} + free {a.free_pages} "
                                  f"!= capacity {a.num_pages - 1}")
        if self.used_pages + self.free_pages != self.capacity:
            raise LedgerError(f"cross-shard conservation violated: used {self.used_pages} "
                              f"+ free {self.free_pages} != capacity {self.capacity}")


def _same_device(a: torch.device, b: torch.device) -> bool:
    """Device equality with an index-less CUDA device read as the current one."""
    def idx(d):
        return (torch.cuda.current_device() if d.index is None else d.index) \
            if d.type == "cuda" else None
    return a.type == b.type and idx(a) == idx(b)


class ShardedStreamScheduler:
    """H shard-local ``StreamScheduler`` lanes behind one submit queue.

    The single scheduler's surface (``submit``, ``step``, ``drain``,
    ``has_work``, ``stats``), plus ``placements`` (request id -> shard),
    ``shard_gauges()`` and the aggregate ``allocator``."""

    def __init__(
        self,
        model: Model,
        gen: GenerationConfig,
        *,
        shards: int = 2,
        placement: str = "least_loaded",
        max_slots: int = 8,
        prompt_len: int = 64,
        decode_prompt_len: Optional[int] = None,
        refresh_shards: int = 1,
        pad_id: int = 0,
        seed: int = 0,
        stream_cb: Optional[StreamCallback] = None,
        clock=time.monotonic,
        paged: bool = False,
        page_size: int = 16,
        kv_pages: Optional[int] = None,     # the total pool over all shards
        devices="auto",                     # "auto", None or one device per shard
        **lane_kw,
    ):
        # a bad topology raises before any engine is built
        if not isinstance(shards, int) or shards < 1:
            raise ConfigError(f"shards must be a positive int, got {shards!r}")
        if shards > 1 and not paged:
            raise ConfigError("shards > 1 requires paged=True: the multi-host design "
                              "shards the PAGED pool (dense KV has no per-shard ledger)")
        if max_slots % shards:
            raise ConfigError(f"shards ({shards}) must divide max_slots ({max_slots}): "
                              "slot planes split evenly across the data axis")
        if placement not in PLACEMENTS:
            raise ConfigError(f"unknown placement {placement!r}; choose from {PLACEMENTS}")
        if placement == "prefix_affinity" and not lane_kw.get("prefix_sharing"):
            raise ConfigError("placement='prefix_affinity' routes on the persistent "
                              "prefix store — it requires prefix_sharing=True")
        if placement == "disagg":
            if shards < 2:
                raise ConfigError("placement='disagg' needs >= 2 shards (refresh + decode)")
            if not (1 <= refresh_shards < shards):
                raise ConfigError(f"refresh_shards ({refresh_shards}) must satisfy "
                                  f"1 <= refresh_shards < shards ({shards})")
            if decode_prompt_len is None:
                decode_prompt_len = prompt_len
            if decode_prompt_len > prompt_len:
                raise ConfigError("decode_prompt_len must not exceed prompt_len: decode "
                                  "shards take the SHORT prompts")
        else:
            if decode_prompt_len is not None:
                raise ConfigError("decode_prompt_len is a disagg knob; it is ignored by "
                                  f"placement={placement!r} — refusing to drop it silently")
            decode_prompt_len = prompt_len
        slots_per = max_slots // shards
        lane_prompt = [prompt_len if (placement != "disagg" or s < refresh_shards)
                       else decode_prompt_len for s in range(shards)]
        lane_pages: list[Optional[int]] = [None] * shards
        if paged:
            for s in range(shards):
                t_total = lane_prompt[s] + gen.gen_length
                if t_total % page_size:
                    raise ConfigError(f"page_size {page_size} must divide shard {s}'s "
                                      f"prompt+gen total {t_total}")
            if kv_pages is not None:
                if kv_pages % shards:
                    raise ConfigError(f"kv_pages ({kv_pages}) must divide evenly across "
                                      f"{shards} shards (per-shard ledgers are equal-size)")
                per = kv_pages // shards
                for s in range(shards):
                    n_vp = (lane_prompt[s] + gen.gen_length) // page_size
                    if per <= n_vp:
                        raise ConfigError(f"shard pool too small: {per} pages/shard cannot "
                                          f"admit shard {s}'s full-length request "
                                          f"({n_vp} pages + garbage page)")
            else:
                # equal-size ledgers under disagg too (its decode lanes would
                # default smaller): one pool shape, so one shared engine
                per = max(slots_per * ((lane_prompt[s] + gen.gen_length) // page_size) + 1
                          for s in range(shards))
            lane_pages = [per] * shards
        if isinstance(devices, str) and devices == "auto":
            devices = ([torch.device("cuda", s) for s in range(shards)]
                       if model.device.type == "cuda" and torch.cuda.device_count() >= shards
                       else None)
        elif devices is not None:
            if len(devices) != shards:
                raise ConfigError(f"devices must hold one device per shard "
                                  f"({len(devices)} != {shards})")
            devices = [torch.device(d) for d in devices]
        # preemption, lazy reservation and prefix sharing compose lane-locally:
        # each lane's constructor refuses the unsound combinations
        self.shards = shards
        self.placement = placement
        self.refresh_shards = refresh_shards if placement == "disagg" else 0
        self.decode_prompt_len = decode_prompt_len
        self.prompt_len = prompt_len
        self.paged = paged
        self.page_size = page_size
        self.gen = gen
        self.clock = clock
        self.devices = devices
        self.lanes: list[StreamScheduler] = []
        # "model" (the model's device) or a device -> the (model, engine) its lanes share
        engines: dict = {}
        for s in range(shards):
            kw = dict(lane_kw)
            dev = model.device if devices is None else devices[s]
            key = "model" if devices is None or _same_device(dev, model.device) else dev
            lane_model, engine = engines.get(key, (model, None))
            if devices is not None:
                kw["device"] = dev
                if engine is None and key != "model":
                    lane_model = Model(model.cfg, device=dev)
                    lane_model.load_state_dict(model.state_dict())
            with _device_guard(dev):
                lane = StreamScheduler(
                    lane_model, gen, max_slots=slots_per, prompt_len=lane_prompt[s],
                    pad_id=pad_id, seed=seed + s, stream_cb=stream_cb, clock=clock,
                    paged=paged, page_size=page_size, kv_pages=lane_pages[s],
                    engine=engine, **kw)
            engines.setdefault(key, (lane_model, lane.engine))
            self.lanes.append(lane)
        self.engine = self.lanes[0].engine
        self.allocator = (ShardedPageAllocator([l.allocator for l in self.lanes])
                          if paged else None)
        self.placements: dict[int, int] = {}    # request_id -> shard
        self.placed = [0] * shards              # admissions per shard

    # ------------------------------------------------------------------
    # placement
    # ------------------------------------------------------------------
    def _lane_load(self, s: int) -> tuple:
        """The load key, a total order: committed pages (resident, plus the
        queued requests' page counts), then queue depth, then the index."""
        lane = self.lanes[s]
        pages = lane.allocator.used_pages if lane.allocator else 0
        for r in lane.queue:
            p = np.asarray(r.prompt, np.int32)[-lane.prompt_len:]
            first_vp, last_vp = lane._pages_needed(len(p), lane._req_blocks(r))
            pages += last_vp - first_vp
        return (pages, len(lane.queue), s)

    def _place(self, req: Request) -> int:
        if self.placement == "disagg":
            pool = (range(self.refresh_shards) if len(req.prompt) > self.decode_prompt_len
                    else range(self.refresh_shards, self.shards))
            return min(pool, key=self._lane_load)
        if self.placement == "prefix_affinity":
            for s, lane in enumerate(self.lanes):
                if not lane.persistent_prefix:
                    continue
                p = np.asarray(req.prompt, np.int32)[-lane.prompt_len:]
                if lane.allocator.lookup_prefix((p.tobytes(), len(p))) is not None:
                    return s            # the owning shard holds the pages
        return min(range(self.shards), key=self._lane_load)

    # ------------------------------------------------------------------
    # the single scheduler's surface
    # ------------------------------------------------------------------
    def submit(self, req: Request) -> None:
        s = self._place(req)
        self.placements[req.request_id] = s
        self.placed[s] += 1
        self.lanes[s].submit(req)

    def step(self) -> bool:
        ran = False
        for lane in self.lanes:
            if lane.has_work():
                with _device_guard(lane.device):
                    ran = lane.step() or ran
        return ran

    def has_work(self) -> bool:
        return any(lane.has_work() for lane in self.lanes)

    def drain(self, *, max_steps: Optional[int] = None,
              max_wall_s: Optional[float] = None) -> list[Request]:
        """Steps every lane in turn until all are empty.  The zero-progress
        watchdog reads every lane's snapshot at once, so a stuck lane cannot
        hide behind one that progresses."""
        t0 = self.clock()
        patience = max(lane._drain_patience for lane in self.lanes)
        idle = steps = 0
        snap = tuple(lane._progress_snapshot() for lane in self.lanes)
        while self.has_work():
            if max_steps is not None and steps >= max_steps:
                raise DrainStalled(f"max_steps={max_steps} exhausted with work remaining",
                                   self._stuck_slots())
            if max_wall_s is not None and self.clock() - t0 > max_wall_s:
                raise DrainStalled(f"max_wall_s={max_wall_s} exceeded with work remaining",
                                   self._stuck_slots())
            self.step()
            steps += 1
            nxt = tuple(lane._progress_snapshot() for lane in self.lanes)
            idle = idle + 1 if nxt == snap else 0
            snap = nxt
            if idle >= patience:
                raise DrainStalled(f"no forward progress in {idle} consecutive steps",
                                   self._stuck_slots())
        return self.completed

    def _stuck_slots(self) -> list:
        return [(s,) + t for s, lane in enumerate(self.lanes) for t in lane._stuck_slots()]

    @property
    def completed(self) -> list[Request]:
        """The lanes' retired requests since the last read, lane by lane."""
        out = []
        for lane in self.lanes:
            out.extend(lane._completed)
            lane._completed = []
        return out

    # ------------------------------------------------------------------
    # stats
    # ------------------------------------------------------------------
    @property
    def stats(self) -> SchedulerStats:
        """Every lane's counters summed (``wall_s`` sums the lanes' loop
        walls; a peak gauge sums the lanes' peaks, an upper bound, since
        they need not coincide)."""
        agg = SchedulerStats()
        for lane in self.lanes:
            for f in dataclasses.fields(SchedulerStats):
                v = getattr(lane.stats, f.name)
                if isinstance(v, list):
                    getattr(agg, f.name).extend(v)
                else:
                    setattr(agg, f.name, getattr(agg, f.name) + v)
        return agg

    def shard_gauges(self) -> list[dict]:
        """Each shard's gauges, with its placements, residents, queue and
        completions."""
        out = []
        for s, lane in enumerate(self.lanes):
            g = lane.stats.gauges()
            g.update(shard=s, placed=self.placed[s],
                     resident=sum(r is not None for r in lane.slot_req),
                     queued=len(lane.queue), completed=lane.stats.completed)
            out.append(g)
        return out

    def reset_stats(self) -> None:
        """Zeroes every lane's counters (after a warm-up), keeping the pool
        size gauge."""
        for lane in self.lanes:
            lane.stats.__init__()
            if lane.allocator is not None:
                lane.stats.pages_total = lane.allocator.num_pages - 1


def _device_guard(dev: torch.device):
    """The current-CUDA-device guard a lane's kernels launch under."""
    return torch.cuda.device(dev) if dev.type == "cuda" else contextlib.nullcontext()
