#!/usr/bin/env python3
"""Seeded serving-trace harness of the PyTorch port: the invariants of
``tools/fuzz_serving.py`` held on ``repro_torch``'s schedulers.

Each *trace* is fully determined by its seed (``trace_flags``, the same
draws as the reference tool's): prompt lengths, duplicate prompts,
staggered arrivals, and the feature flags (paged pool, prefix sharing,
block-causal with the persistent store, lazy window reservation, early
advance, the adaptive cache, sampling, preemption on a tight pool, and a
2-shard ``ShardedStreamScheduler`` with a drawn placement).  The trace is
driven step by step, and after every step each lane's page ledger must
hold:

* refcounts are never negative, free and used pages partition the pool,
  the free list holds no duplicate and no page with a live claim, and the
  garbage page (0) carries no claim and is never mapped;
* claims cover mappings: a page mapped by k residents has refcount >= k,
  and no slot maps a page twice;
* the claims balance: every refcount is a slot's page, a cohort's
  copy-on-write reserve or a persistent store entry's;
* the scheduler's host copy of the block tables equals the device's;

and, with two shards, conservation across them
(``ShardedPageAllocator.check_conservation``).  At the end every request is
in exactly one typed terminal state: completed (its output equal to the
offline ``engine.generate`` of its shard's layout, prompt starts and
sample seeds, with the lane's key ``prng_key(s)``), rejected
(``DeadlineUnmeetable``) or quarantined (``PoisonedRequest``), and only
the persistent store still holds pages.

``--chaos`` raises every fault probability: NaN bursts written into a
victim's private K/V (under the int8 cache, into the scales, the float
planes a read sees), deadline storms, and preemption on a tight pool.

Library use::

    res = run_trace(model, seed)            # raises on any violation

CLI (reduced 4-layer LLaDA-8B with seeded random weights)::

    PYTHONPATH=src python tools/torch_fuzz_serving.py --device cpu --traces 20
    PYTHONPATH=src python tools/torch_fuzz_serving.py --device cpu --traces 20 --chaos

A failing trace prints its seed and flags and, with ``--artifact`` (or
``$REPRO_FUZZ_ARTIFACT``), writes them as JSON.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

PROMPT_LEN = 16
GEN_LENGTH = 16
BLOCK_LENGTH = 8
PAGE_SIZE = 8
N_VP = (PROMPT_LEN + GEN_LENGTH) // PAGE_SIZE


def trace_flags(seed: int, *, chaos: bool = False) -> dict:
    """A seed's trace configuration (pure).  ``chaos`` raises the fault
    probabilities; the fault draws come after every base draw, and the
    shard draws last, so a seed's base scenario is the same either way."""
    rng = np.random.default_rng(seed)
    paged = bool(rng.random() < 0.85)
    lazy = bool(paged and rng.random() < 0.35)
    sharing = bool(paged and rng.random() < 0.6)
    flags = dict(
        n_requests=int(rng.integers(2, 6)),
        max_slots=int(rng.integers(1, 4)),
        dup_ratio=float(rng.choice([0.0, 0.5, 1.0])),
        arrival_span=int(rng.integers(0, 7)),
        paged=paged,
        prefix_sharing=sharing,
        block_causal=bool(rng.random() < 0.5),
        lazy_reserve=lazy,
        window_blocks=1 if lazy else 0,
        early_advance=bool(rng.random() < 0.5),
        adaptive_cache=bool(rng.random() < 0.35),
        temperature=float(rng.choice([0.0, 0.7])),
        tight_pool=bool(paged and rng.random() < 0.3),
    )
    n = flags["n_requests"]
    flags["inject_nan"] = bool(rng.random() < (0.6 if chaos else 0.25))
    flags["nan_step"] = int(rng.integers(2, 13))
    storm = bool(rng.random() < (0.5 if chaos else 0.2))
    # indexes into _DEADLINES: impossible, marginal, generous, none
    flags["deadline_picks"] = [int(x) for x in rng.integers(0, 4, n)] if storm else [3] * n
    preempt_ok = paged and not sharing and not lazy
    preempt = bool(preempt_ok and rng.random() < (0.7 if chaos else 0.35))
    flags["preemption"] = preempt
    flags["priorities"] = [int(x) for x in rng.integers(0, 3, n)] if preempt else [0] * n
    if preempt:
        # preemption only fires when a higher class starves
        flags["tight_pool"] = True
    # two shards need the paged pool and an even slot count; prefix_affinity
    # routes on the persistent store, so only traces that have one draw it
    shard_ok = flags["paged"] and flags["max_slots"] % 2 == 0
    flags["shards"] = 2 if (shard_ok and rng.random() < 0.5) else 1
    flags["placement"] = (
        "prefix_affinity" if (flags["shards"] == 2 and flags["prefix_sharing"]
                              and flags["block_causal"] and rng.random() < 0.5)
        else "least_loaded")
    return flags


# storm budgets: 0.0 rejects at submit, 1e-4 at admission once a wait or an
# estimate registers, 60.0 admits, None takes no deadline
_DEADLINES = (0.0, 1e-4, 60.0, None)


def _gen_config(flags: dict):
    from repro_torch.configs import GenerationConfig, SkipStage

    kw = dict(mode="es", skip_stages=(SkipStage(1, 0.5),), gen_length=GEN_LENGTH,
              block_length=BLOCK_LENGTH, prompt_refresh_period=2, block_refresh_period=4,
              temperature=flags["temperature"], window_blocks=flags["window_blocks"],
              block_causal=flags["block_causal"])
    if flags["adaptive_cache"]:
        kw.update(cache_prompt_interval=2, cache_refresh_fraction=0.5)
    return GenerationConfig(**kw)


def _requests(flags: dict, vocab_size: int, seed: int):
    from repro_torch.runtime import Request

    rng = np.random.default_rng(seed + 1)
    n = flags["n_requests"]
    reqs, prompts = [], []
    for i in range(n):
        if prompts and rng.random() < flags["dup_ratio"]:
            p = prompts[int(rng.integers(0, len(prompts)))].copy()
        else:
            p = rng.integers(3, vocab_size, int(rng.integers(4, PROMPT_LEN + 1))).astype(np.int32)
        prompts.append(p)
        reqs.append(Request(prompt=p.copy(), sample_seed=1000 + i,
                            priority=flags.get("priorities", [0] * n)[i],
                            deadline_s=_DEADLINES[flags.get("deadline_picks", [3] * n)[i]]))
    arrivals = sorted(int(a) for a in rng.integers(0, flags["arrival_span"] + 1, n))
    return reqs, arrivals


def inject_nan(sched) -> bool:
    """Writes NaN into one resident's K/V in place (a seeded burst).  The
    victim is the lowest-index active resident.  Paged: the page under its
    block start, only if the victim holds it alone (a poisoned row must not
    touch a co-resident, and shared pages are never written after
    divergence); dense: the victim's row at its block start.  Every float
    pool plane is hit: under the int8 cache that is the scales, which every
    read of the codes multiplies in.  Returns False (retry next step) when
    no victim is eligible."""
    st = sched.state
    active = st.active.cpu().numpy()
    victims = [s for s, r in enumerate(sched.slot_req)
               if r is not None and active[s] and s not in sched.stalled]
    if not victims:
        return False
    slot = victims[0]
    bs = int(st.bs[slot])
    if sched.paged:
        vp = bs // sched.page_size
        bt = st.block_tables.cpu().numpy()
        if vp >= bt.shape[1]:
            return False
        pg = int(bt[slot, vp])
        if pg <= 0 or sched.allocator.refcount(pg) != 1:
            return False
        index = (slice(None), pg)
    else:
        index = (slice(None), slot, bs)
    for pool in st.cache:
        if pool.is_floating_point():
            pool[index] = float("nan")
    return True


def check_allocator_invariants(sched) -> None:
    """Asserts every pool-accounting invariant of one live scheduler (a lane)."""
    al = sched.allocator
    if al is None:
        return
    rc = al._refcount
    assert all(r >= 0 for r in rc), f"negative refcount: {rc}"
    assert len(set(al._free)) == len(al._free), "duplicate page in free list"
    assert all(rc[p] == 0 for p in al._free), "freed page with a live claim"
    assert al.used_pages + al.free_pages == al.num_pages - 1, \
        "used/free do not partition the pool"
    assert rc[0] == 0, "the garbage page must never carry a claim"
    bt = sched.state.block_tables.cpu().numpy()
    assert np.array_equal(bt, sched._bt), "host block tables differ from the device's"
    mapped: dict[int, int] = {}
    for slot, req in enumerate(sched.slot_req):
        if req is None:
            continue
        row = [int(pg) for pg in bt[slot] if pg >= 0]
        assert 0 not in row, f"garbage page mapped by slot {slot}"
        assert len(set(row)) == len(row), f"slot {slot} maps a physical page twice"
        for pg in row:
            mapped[pg] = mapped.get(pg, 0) + 1
    for pg, n in mapped.items():
        assert rc[pg] >= n, (f"page {pg} mapped by {n} slots but refcount {rc[pg]} — "
                             "a multiply-mapped page must be refcounted shared")
    ledger = sum(len(p) for p in sched.slot_pages)
    ledger += sum(len(res) for c in sched.cohorts for res in c["reserve"].values())
    if al.persistent:
        ledger += sum(len(page_map) for _, page_map in al._prefix.values())
    assert ledger == sum(rc), (f"claim ledger {ledger} != total refcount {sum(rc)} — a "
                               "claim leaked or double-counted")


def run_trace(model, seed: int, *, flags: dict | None = None) -> dict:
    """Runs one seeded trace on ``model``'s device; raises AssertionError (or
    a typed ``SchedulerError``) on any violation or replay divergence, and
    returns summary stats and per-request tokens (``outputs``: request
    index -> tokens of the completed requests)."""
    from repro_torch.core import prng
    from repro_torch.core.engine import DiffusionEngine
    from repro_torch.runtime import (
        DeadlineUnmeetable,
        PoisonedRequest,
        ShardedStreamScheduler,
        StreamScheduler,
        pad_and_stack,
    )

    flags = dict(flags or trace_flags(seed))
    gen = _gen_config(flags)
    reqs, arrivals = _requests(flags, model.cfg.vocab_size, seed)
    shards = flags.get("shards", 1)
    skw = dict(max_slots=flags["max_slots"], prompt_len=PROMPT_LEN,
               early_advance=flags["early_advance"], device=model.device)
    if flags["paged"]:
        skw.update(paged=True, page_size=PAGE_SIZE, prefix_sharing=flags["prefix_sharing"],
                   lazy_reserve=flags["lazy_reserve"],
                   preemption=flags.get("preemption", False))
        if flags["tight_pool"]:
            # about 1.5 requests a shard: page gating, FIFO waits, store
            # evictions and, with preemption, forced spills
            skw["kv_pages"] = shards * (N_VP + N_VP // 2 + 1)
    if shards > 1:
        sched = ShardedStreamScheduler(model, gen, shards=shards,
                                       placement=flags.get("placement", "least_loaded"), **skw)
        lanes = sched.lanes
    else:
        sched = StreamScheduler(model, gen, **skw)
        lanes = [sched]
    pending = list(zip(arrivals, reqs))
    steps = 0
    injected = not flags.get("inject_nan", False)
    while pending or sched.has_work():
        while pending and pending[0][0] <= steps:
            sched.submit(pending.pop(0)[1])
        sched.step()
        if not injected and steps >= flags["nan_step"]:
            # retried until some lane has an eligible victim
            injected = any(inject_nan(lane) for lane in lanes)
        for lane in lanes:
            check_allocator_invariants(lane)
        if shards > 1 and sched.allocator is not None:
            sched.allocator.check_conservation()
        steps += 1
        assert steps < 5000, "trace did not terminate"
    done_ok = [r for r in reqs if r.error is None]
    rejected = [r for r in reqs if isinstance(r.error, DeadlineUnmeetable)]
    poisoned = [r for r in reqs if isinstance(r.error, PoisonedRequest)]
    assert len(done_ok) + len(rejected) + len(poisoned) == len(reqs), \
        "a request retired with an untyped error"
    assert all(r.output is not None for r in done_ok), "a completed request has no output"
    assert all(r.output is None for r in rejected + poisoned), \
        "a failed request leaked a partial output"
    stats = sched.stats
    assert stats.completed == len(done_ok)
    assert stats.deadline_rejects == len(rejected)
    assert stats.poisoned_requests == len(poisoned)
    for lane in lanes:
        if lane.allocator is not None:
            store = (sum(len(m) for _, m in lane.allocator._prefix.values())
                     if lane.allocator.persistent else 0)
            assert lane.allocator.used_pages == store, "pages leaked past retirement"
    if done_ok:
        # the offline replay of each shard's completions, in the trace's
        # layout: paged masks the left pad (prompt_start), dense attends it
        ekw = dict(paged=True, page_size=PAGE_SIZE) if flags["paged"] else {}
        eng = DiffusionEngine(model, gen, device=model.device, **ekw)
        groups: dict[int, list] = {}
        for r in done_ok:
            groups.setdefault(sched.placements[r.request_id] if shards > 1 else 0, []).append(r)
        for s, grp in sorted(groups.items()):
            starts = [PROMPT_LEN - len(r.prompt) if flags["paged"] else 0 for r in grp]
            ref = eng.generate(torch.from_numpy(pad_and_stack(grp, 0, PROMPT_LEN)),
                               prompt_start=torch.tensor(starts, dtype=torch.int32),
                               key=prng.prng_key(s),
                               sample_seeds=torch.tensor([r.sample_seed for r in grp]))
            ref = ref.cpu().numpy()
            for i, r in enumerate(grp):
                np.testing.assert_array_equal(
                    r.output, ref[i, PROMPT_LEN:],
                    err_msg=f"seed {seed}: request {r.request_id} (shard {s}) diverged from "
                            f"offline replay (flags {flags})")
    return dict(seed=seed, steps=steps, flags=flags,
                outputs={i: r.output for i, r in enumerate(reqs) if r.error is None},
                prefix_hits=stats.prefix_hits, prefix_evictions=stats.prefix_evictions,
                cow_forks=stats.cow_forks, preemptions=stats.preemptions,
                pages_spilled=stats.pages_spilled, deadline_rejects=stats.deadline_rejects,
                poisoned_requests=stats.poisoned_requests)


def write_artifact(path: str, seed: int, flags: dict, error: str) -> None:
    with open(path, "w") as f:
        json.dump(dict(seed=seed, flags=flags, error=error), f, indent=2)


def build_reduced_model(device: str = "cpu"):
    """Reduced LLaDA-8B, 4 layers, f32, random weights from seed 0."""
    from repro_torch import configs
    from repro_torch.models import Model

    cfg = dataclasses.replace(configs.reduced(configs.get_config("llada-8b")), n_layers=4)
    return Model(cfg, device=device).init(torch.Generator(device=device).manual_seed(0))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--traces", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0, help="first trace seed")
    ap.add_argument("--chaos", action="store_true",
                    help="raise every fault probability (NaN bursts, deadline storms, "
                         "forced preemption)")
    ap.add_argument("--artifact", default=os.environ.get("REPRO_FUZZ_ARTIFACT", ""),
                    help="write the failing seed and flags here as JSON")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu (the kernels' plain versions)")
    args = ap.parse_args(argv)
    from repro_torch.device import resolve_device
    from repro_torch.runtime import SchedulerError

    model = build_reduced_model(resolve_device(args.device))
    for seed in range(args.seed, args.seed + args.traces):
        flags = trace_flags(seed, chaos=args.chaos)
        try:
            res = run_trace(model, seed, flags=flags)
        except (AssertionError, SchedulerError) as e:
            print(f"FAIL seed={seed} flags={flags}\n{e}", file=sys.stderr)
            if args.artifact:
                write_artifact(args.artifact, seed, flags, str(e))
            return 1
        print(f"ok seed={res['seed']} steps={res['steps']} shards={flags['shards']} "
              f"hits={res['prefix_hits']} evict={res['prefix_evictions']} "
              f"forks={res['cow_forks']} preempt={res['preemptions']} "
              f"spill={res['pages_spilled']} rejects={res['deadline_rejects']} "
              f"poisoned={res['poisoned_requests']}")
    print(f"{args.traces} traces: zero divergences, zero violations")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
