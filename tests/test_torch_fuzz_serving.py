"""The serving fuzz harness on the port (``tools/torch_fuzz_serving.py``).

* its ``trace_flags`` equal the reference tool's for seeds 0-63, with and
  without chaos, so both tools fuzz the same scenarios;
* the smoke seeds (0, 1, 2) and the chaos seeds (2, 3) of
  ``tests/test_serving_fuzz.py`` pass on the port: the ledger invariants
  after every step (per lane, and conservation across the 2 shards that
  chaos seed 3 draws), the three typed terminal states, the offline replay
  of every completed request;
* seed 1 (paged, block-causal with the persistent store, sampled, a tight
  pool, no deadline storm): the completed requests' tokens equal the
  reference harness's ``run_trace`` on the same weights;
* the checker fires on a leaked claim, on host block tables that differ
  from the device's, and on a live page on a lane's free list;
* ``inject_nan`` under the int8 cache writes the scales;
* the ``fuzz``-marked sweeps (left out of tier-1 by ``pyproject.toml``).

Reduced LLaDA-8B (4 layers, weight matrices x10) from ``test_torch_engine``:
the reference's seeded tree, converted.
"""
import importlib.util
import os

import numpy as np
import pytest
import torch

from repro_torch.runtime import (
    Request,
    SchedulerError,
    ShardedStreamScheduler,
    StreamScheduler,
)
from test_torch_engine import models


def _load(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(os.path.dirname(__file__), "..", "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


tfuzz = _load("torch_fuzz_serving")
jfuzz = _load("fuzz_serving")

SMOKE_SEEDS = (0, 1, 2)
CHAOS_SEEDS = (2, 3)
N_TRACES = int(os.environ.get(
    "REPRO_FUZZ_TRACES", "6" if os.environ.get("REPRO_BENCH_FAST") else "20"))


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The reduced models' ops are tiny: one intra-op thread runs them as
    fast as eight alone, and keeps them fast when several test workers
    share the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _run_seed(seed: int, *, chaos: bool = False) -> dict:
    _, _, tm = models("llada-8b")
    flags = tfuzz.trace_flags(seed, chaos=chaos)
    try:
        return tfuzz.run_trace(tm, seed, flags=flags)
    except (AssertionError, SchedulerError) as e:
        artifact = os.environ.get("REPRO_FUZZ_ARTIFACT", "")
        if artifact:
            tfuzz.write_artifact(artifact, seed, flags, str(e))
        raise


@pytest.mark.parametrize("chaos", [False, True], ids=["base", "chaos"])
def test_trace_flags_equal_reference(chaos):
    for seed in range(64):
        assert tfuzz.trace_flags(seed, chaos=chaos) == jfuzz.trace_flags(seed, chaos=chaos), seed
    assert tfuzz._DEADLINES == jfuzz._DEADLINES


@pytest.mark.parametrize("seed", SMOKE_SEEDS)
def test_fuzz_smoke(seed):
    res = _run_seed(seed)
    assert res["steps"] > 0


@pytest.mark.parametrize("seed", CHAOS_SEEDS)
def test_chaos_smoke(seed):
    """Seeded NaN bursts and deadline storms resolve to typed verdicts with
    no ledger violation (seed 3 runs on 2 shards)."""
    res = _run_seed(seed, chaos=True)
    assert res["poisoned_requests"] + res["deadline_rejects"] > 0
    if seed == 3:
        assert res["flags"]["shards"] == 2


def test_smoke_tokens_equal_reference_run_trace():
    """Seed 1 draws no deadline storm, so which requests complete does not
    depend on the clock; their tokens equal the reference harness's."""
    jm, params, tm = models("llada-8b")
    flags = tfuzz.trace_flags(1)
    assert flags["deadline_picks"] == [3] * flags["n_requests"] and flags["paged"]
    captured = []
    make_requests = jfuzz._requests

    def capture(*a, **k):
        reqs, arrivals = make_requests(*a, **k)
        captured.extend(reqs)
        return reqs, arrivals

    jfuzz._requests = capture          # this test's own copy of the tool's module
    try:
        jfuzz.run_trace(jm, params, 1, flags=flags)
    finally:
        jfuzz._requests = make_requests
    res = tfuzz.run_trace(tm, 1, flags=flags)
    want = {i: np.asarray(r.output) for i, r in enumerate(captured) if r.error is None}
    assert set(res["outputs"]) == set(want) and want
    for i, out in res["outputs"].items():
        np.testing.assert_array_equal(out, want[i], err_msg=f"request {i}")
    assert len({tuple(o) for o in want.values()}) > 1


def _one_step_scheduler(tm, shards):
    gen = tfuzz._gen_config(tfuzz.trace_flags(0) | {"paged": True})
    kw = dict(max_slots=2, prompt_len=tfuzz.PROMPT_LEN, paged=True,
              page_size=tfuzz.PAGE_SIZE, device="cpu")
    sched = (ShardedStreamScheduler(tm, gen, shards=2, **kw) if shards == 2
             else StreamScheduler(tm, gen, **kw))
    rng = np.random.default_rng(0)
    for _ in range(shards):
        sched.submit(Request(prompt=rng.integers(3, tm.cfg.vocab_size,
                                                 tfuzz.PROMPT_LEN).astype(np.int32)))
    sched.step()
    return sched


def test_harness_catches_a_leaked_claim():
    """A corrupted refcount must trip the ledger check (the suite must not
    degenerate into a no-op)."""
    _, _, tm = models("llada-8b")
    sched = _one_step_scheduler(tm, 1)
    tfuzz.check_allocator_invariants(sched)
    victim = sched.slot_pages[0][0]
    sched.allocator._refcount[victim] += 1
    with pytest.raises(AssertionError, match="ledger"):
        tfuzz.check_allocator_invariants(sched)
    sched.allocator._refcount[victim] -= 1
    sched._bt[0, 0] = 7
    with pytest.raises(AssertionError, match="host block tables"):
        tfuzz.check_allocator_invariants(sched)


def test_harness_catches_a_live_page_on_a_lanes_free_list():
    """On a sharded scheduler the checker runs per lane: a page that a
    resident still maps, pushed back on its lane's free list, trips it.
    (``check_conservation`` holds by construction here, in both packages:
    ``used_pages`` is computed from the free list.)"""
    _, _, tm = models("llada-8b")
    sched = _one_step_scheduler(tm, 2)
    for lane in sched.lanes:
        tfuzz.check_allocator_invariants(lane)
    sched.allocator.check_conservation()
    lane = sched.lanes[1]
    lane.allocator._free.append(lane.slot_pages[0][0])
    with pytest.raises(AssertionError, match="live claim"):
        tfuzz.check_allocator_invariants(lane)


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_inject_nan_writes_the_int8_scales(paged):
    """Under the int8 cache the codes are integers; the burst lands in the
    float scale planes, which every read multiplies in."""
    _, _, tm = models("llada-8b")
    gen = tfuzz._gen_config(tfuzz.trace_flags(0))
    kw = dict(paged=True, page_size=tfuzz.PAGE_SIZE) if paged else {}
    sched = StreamScheduler(tm, gen, max_slots=2, prompt_len=tfuzz.PROMPT_LEN, device="cpu",
                            kv_cache_dtype="int8", **kw)
    sched.submit(Request(prompt=np.arange(3, 3 + tfuzz.PROMPT_LEN, dtype=np.int32)))
    sched.step()
    codes = sched.state.cache.k.clone()
    assert tfuzz.inject_nan(sched)
    assert torch.equal(sched.state.cache.k, codes)
    for scale in (sched.state.cache.k_scale, sched.state.cache.v_scale):
        assert scale.isnan().any() and not scale.isnan().all()


@pytest.mark.fuzz
def test_fuzz_sweep():
    covered = set()
    for seed in range(len(SMOKE_SEEDS), len(SMOKE_SEEDS) + N_TRACES):
        res = _run_seed(seed)
        covered.update(k for k, v in res["flags"].items() if v)
    assert "paged" in covered and "block_causal" in covered, sorted(covered)


@pytest.mark.fuzz
def test_chaos_sweep():
    fired = {"inject_nan": 0, "deadline_rejects": 0, "poisoned_requests": 0}
    for seed in range(100, 100 + N_TRACES):
        res = _run_seed(seed, chaos=True)
        fired["inject_nan"] += bool(res["flags"]["inject_nan"])
        for k in ("deadline_rejects", "poisoned_requests"):
            fired[k] += res[k]
    assert fired["inject_nan"] > 0 and fired["deadline_rejects"] > 0, fired
