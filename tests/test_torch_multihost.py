"""The port's ``ShardedStreamScheduler`` against the reference's, on the CPU.

Both packages run in one process on the request sets of
``tests/test_multihost.py`` (2 shards, 4 slots, prompt 16, pages of 8, gen
32 in blocks of 8, early advance; the reference with ``devices=None``), on
reduced LLaDA-8B (4 layers, weight matrices x10, from ``test_torch_engine``):

* ``least_loaded`` greedy and at temperature 0.7, ``prefix_affinity`` with
  block-causal attention and the persistent store, and ``disagg`` with one
  refresh shard at prompt 32 and decode shards at 16: equal placements,
  equal tokens for each request, and equal count gauges in ``stats`` and in
  ``shard_gauges()`` (the wall-clock ones left out);
* within the port: each lane's outputs equal a single-shard
  ``StreamScheduler`` fed that lane's trace with seed ``seed + s``;
  conservation and every ledger invariant of the fuzz harness after every
  step; the aggregate watchdog raises ``DrainStalled`` for a stuck lane
  behind a progressing one; every ``ConfigError`` of the reference's
  topology test, with the reference's message;
* the launcher: ``validate`` refuses exactly the argument sets the
  reference's launcher refuses, and ``--shards 2`` runs end to end, least
  loaded and disaggregated.
"""
import dataclasses
import importlib.util
import os

import numpy as np
import pytest
import torch

from repro.runtime import ConfigError as JConfigError
from repro.runtime import Request as JRequest
from repro.runtime import ShardedStreamScheduler as JSharded
from repro_torch.launch import serve
from repro_torch.runtime import (
    ConfigError,
    DrainStalled,
    Request,
    ShardedStreamScheduler,
    StreamScheduler,
)
from test_torch_engine import gen_configs, models

_spec = importlib.util.spec_from_file_location(
    "torch_fuzz_serving",
    os.path.join(os.path.dirname(__file__), "..", "tools", "torch_fuzz_serving.py"))
tfuzz = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(tfuzz)

PROMPT_LEN, PS = 16, 8
GEN = dict(gen_length=32, block_length=8)
# wall-clock gauges; every other gauge is a count and must be equal
CLOCK_GAUGES = {"admission_wait_p50", "resume_p50"}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The reduced models' ops are tiny: one intra-op thread runs them as
    fast as eight alone, and keeps them fast when several test workers
    share the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _gens(**kw):
    jgen, tgen = gen_configs(mode="es", skip_stages=((1, 0.5),), prompt_refresh_period=2,
                             block_refresh_period=4, **kw)
    return dataclasses.replace(jgen, **GEN), dataclasses.replace(tgen, **GEN)


def _requests(make, vocab, n, plen=PROMPT_LEN, seed=3, base_id=0):
    rng = np.random.default_rng(seed)
    return [make(prompt=rng.integers(3, vocab, plen).astype(np.int32), request_id=base_id + i,
                 sample_seed=base_id + i) for i in range(n)]


def _both(gen_kw, sched_kw, script):
    """Runs ``script(sched, make_request, vocab) -> requests`` on the
    reference's sharded scheduler and on the port's."""
    jm, params, tm = models("llada-8b")
    jgen, tgen = _gens(**gen_kw)
    base = dict(shards=2, max_slots=4, prompt_len=PROMPT_LEN, paged=True, page_size=PS,
                early_advance=True, devices=None)
    base.update(sched_kw)
    jsched = JSharded(jm, params, jgen, **base)
    jreqs = script(jsched, JRequest, tm.cfg.vocab_size)
    tsched = ShardedStreamScheduler(tm, tgen, device="cpu", **base)
    treqs = script(tsched, Request, tm.cfg.vocab_size)
    return dict(j=jsched, t=tsched, jreqs=jreqs, treqs=treqs, gen=tgen, kw=base)


def _submit_all(n):
    def script(sched, make, vocab):
        reqs = _requests(make, vocab, n)
        for r in reqs:
            sched.submit(r)
        sched.drain()
        return reqs
    return script


def _affinity(sched, make, vocab):
    """The reference's affinity case: one request, drained; then its prompt
    again beside two new prompts, so the store hit beats the load."""
    first = _requests(make, vocab, 1)[0]
    sched.submit(first)
    sched.drain()
    again = make(prompt=first.prompt.copy(), request_id=101, sample_seed=first.sample_seed)
    others = _requests(make, vocab, 2, seed=8, base_id=102)
    for r in others + [again]:
        sched.submit(r)
    sched.drain()
    return [first] + others + [again]


def _disagg(sched, make, vocab):
    longs = _requests(make, vocab, 2, plen=32, seed=5, base_id=0)
    shorts = _requests(make, vocab, 3, plen=16, seed=6, base_id=10)
    for r in longs + shorts:
        sched.submit(r)
    sched.drain()
    return longs + shorts


CASES = {
    "least_loaded-greedy": (dict(), dict(), _submit_all(6)),
    "least_loaded-t0.7": (dict(temperature=0.7), dict(), _submit_all(6)),
    "prefix_affinity": (dict(block_causal=True),
                        dict(placement="prefix_affinity", prefix_sharing=True), _affinity),
    "disagg": (dict(), dict(placement="disagg", refresh_shards=1, prompt_len=32,
                            decode_prompt_len=16), _disagg),
}


@pytest.fixture(scope="module")
def runs():
    """Each scenario run once per module, in both packages."""
    return {name: _both(*case) for name, case in CASES.items()}


def _count_fields(jstats, tstats):
    return [f.name for f in dataclasses.fields(jstats)
            if isinstance(getattr(jstats, f.name), int) and hasattr(tstats, f.name)]


@pytest.mark.parametrize("case", list(CASES))
def test_sharded_matches_reference(runs, case):
    r = runs[case]
    j, t = r["j"], r["t"]
    assert t.placements == j.placements and t.placed == j.placed
    for tr, jr in zip(r["treqs"], r["jreqs"]):
        assert tr.error is None and jr.error is None
        np.testing.assert_array_equal(tr.output, np.asarray(jr.output),
                                      err_msg=f"request {tr.request_id}")
    jst, tst = j.stats, t.stats
    fields = _count_fields(jst, tst)
    assert "completed" in fields and "peak_pages_in_use" in fields
    assert {f: getattr(tst, f) for f in fields} == {f: getattr(jst, f) for f in fields}
    for tg, jg in zip(t.shard_gauges(), j.shard_gauges()):
        keys = set(jg) - CLOCK_GAUGES
        assert {k: tg[k] for k in keys} == {k: jg[k] for k in keys}
    assert tst.completed == len(r["treqs"]) and t.allocator.used_pages == (
        j.allocator.used_pages)
    assert len({tuple(x.output) for x in r["treqs"]}) > 1


def test_placements_of_each_policy(runs):
    """What each policy decided, in the port (equal to the reference's above)."""
    assert runs["least_loaded-greedy"]["t"].placed == [3, 3]
    aff = runs["prefix_affinity"]["t"]
    assert aff.placements[101] == aff.placements[0]
    assert aff.stats.prefix_hits >= 1
    dis = runs["disagg"]["t"]
    assert [dis.placements[i] for i in (0, 1, 10, 11, 12)] == [0, 0, 1, 1, 1]
    assert [lane.prompt_len for lane in dis.lanes] == [32, 16]
    # one engine for both widths, and equal pools on both lanes
    assert dis.lanes[0].engine is dis.lanes[1].engine
    assert dis.lanes[0].allocator.num_pages == dis.lanes[1].allocator.num_pages


@pytest.mark.parametrize("case", ["least_loaded-t0.7", "disagg"])
def test_per_shard_replay_equals_single_shard(runs, case):
    """Placement is final: each lane's requests through a fresh single-shard
    scheduler with the lane's seed give the same tokens."""
    r = runs[case]
    sched, kw = r["t"], r["kw"]
    _, _, tm = models("llada-8b")
    for s, lane in enumerate(sched.lanes):
        lane_reqs = [q for q in r["treqs"] if sched.placements[q.request_id] == s]
        assert lane_reqs
        replay = StreamScheduler(tm, r["gen"], device="cpu", max_slots=kw["max_slots"] // 2,
                                 prompt_len=lane.prompt_len, paged=True, page_size=PS,
                                 early_advance=True, seed=s,
                                 kv_pages=lane.allocator.num_pages)
        copies = [Request(prompt=q.prompt.copy(), request_id=q.request_id,
                          sample_seed=q.sample_seed) for q in lane_reqs]
        for q in copies:
            replay.submit(q)
        replay.drain()
        for q, c in zip(lane_reqs, copies):
            np.testing.assert_array_equal(q.output, c.output,
                                          err_msg=f"shard {s} request {q.request_id}")


def test_conservation_and_invariants_every_step():
    """A staggered sampled trace with prefix sharing of duplicates: after
    every step each lane's ledger invariants and the law across shards hold,
    and every page comes back."""
    _, _, tm = models("llada-8b")
    _, tgen = _gens(temperature=0.7)
    sched = ShardedStreamScheduler(tm, tgen, device="cpu", shards=2, max_slots=4,
                                   prompt_len=PROMPT_LEN, paged=True, page_size=PS,
                                   early_advance=True, prefix_sharing=True, kv_pages=20)
    reqs = _requests(Request, tm.cfg.vocab_size, 4)
    reqs += [Request(prompt=reqs[0].prompt.copy()) for _ in range(2)]
    step = 0
    while step < 12 or sched.has_work():
        if step % 2 == 0 and step // 2 < len(reqs):
            sched.submit(reqs[step // 2])
        sched.step()
        for lane in sched.lanes:
            tfuzz.check_allocator_invariants(lane)
        sched.allocator.check_conservation()
        step += 1
    assert all(r.error is None and r.output is not None for r in reqs)
    assert sched.allocator.used_pages == 0 and sched.allocator.capacity == 18


def test_watchdog_sees_a_stuck_lane_behind_a_progressing_one():
    _, _, tm = models("llada-8b")
    _, tgen = _gens()
    sched = ShardedStreamScheduler(tm, tgen, device="cpu", shards=2, max_slots=4,
                                   prompt_len=PROMPT_LEN, paged=True, page_size=PS,
                                   early_advance=True)
    for r in _requests(Request, tm.cfg.vocab_size, 4):
        sched.submit(r)
    sched.step()
    with pytest.raises(DrainStalled, match="max_steps=1"):
        sched.drain(max_steps=1)
    # lane 1 freezes with residents; lane 0 goes on to finish its requests
    sched.lanes[1].step = lambda: True
    for lane in sched.lanes:
        lane._drain_patience = 20       # above the 8 steps of a block
    with pytest.raises(DrainStalled, match="no forward progress") as err:
        sched.drain()
    assert not sched.lanes[0].has_work() and sched.lanes[0].stats.completed == 2
    assert err.value.slots and {t[0] for t in err.value.slots} == {1}
    assert "shard 1 slot" in str(err.value)


TOPOLOGY = {
    "divide max_slots": dict(shards=3, max_slots=4, paged=True),
    "requires paged": dict(shards=2, max_slots=4),
    "divide evenly": dict(shards=2, max_slots=4, kv_pages=31, paged=True),
    "unknown placement": dict(shards=2, max_slots=4, placement="round_robin", paged=True),
    "prefix store": dict(shards=2, max_slots=4, placement="prefix_affinity", paged=True),
    "disagg knob": dict(shards=2, max_slots=4, decode_prompt_len=8, paged=True),
    "refresh_shards": dict(shards=2, max_slots=4, placement="disagg", refresh_shards=2,
                           paged=True),
    "pool too small": dict(shards=2, max_slots=4, kv_pages=12, paged=True),
    "positive int": dict(shards=0, max_slots=4, paged=True),
    "disagg needs 2": dict(shards=1, max_slots=4, placement="disagg", paged=True),
    "decode_prompt_len exceeds": dict(shards=2, max_slots=4, placement="disagg",
                                      prompt_len=16, decode_prompt_len=32, paged=True),
    "page_size divide": dict(shards=2, max_slots=4, placement="disagg",
                             decode_prompt_len=12, paged=True),
    "devices length": dict(shards=2, max_slots=4, paged=True, devices=["cpu"]),
}


@pytest.mark.parametrize("case", list(TOPOLOGY))
def test_topology_validation_raises_with_reference_message(case):
    """Every ``ConfigError`` of the reference's topology test (and of its
    other checks), raised before any engine is built, with the reference's
    message."""
    jm, params, tm = models("llada-8b")
    jgen, tgen = _gens()
    kw = dict(TOPOLOGY[case], page_size=PS)
    kw.setdefault("devices", None)
    with pytest.raises(JConfigError) as jerr:
        JSharded(jm, params, jgen, **kw)
    with pytest.raises(ConfigError) as terr:
        ShardedStreamScheduler(tm, tgen, device="cpu", **kw)
    assert str(terr.value) == str(jerr.value)


def test_stats_rollup_shard_gauges_and_reset(runs):
    sched = runs["least_loaded-greedy"]["t"]
    agg = sched.stats
    assert agg.completed == sum(lane.stats.completed for lane in sched.lanes) == 6
    assert agg.steps == sum(lane.stats.steps for lane in sched.lanes)
    assert len(agg.latencies_s) == 6 and agg.tps == agg.goodput > 0
    assert agg.requests == 6 and agg.tokens_generated == agg.tokens_out == 6 * 32
    gauges = sched.shard_gauges()
    assert [g["shard"] for g in gauges] == [0, 1]
    assert sum(g["placed"] for g in gauges) == 6
    assert all(g["resident"] == g["queued"] == 0 for g in gauges)
    # every field of the stats is a number or a list, so the rollup can sum it
    assert all(isinstance(getattr(agg, f.name), (int, float, list))
               for f in dataclasses.fields(agg))


def test_reset_stats_keeps_the_pool_gauge():
    _, _, tm = models("llada-8b")
    _, tgen = _gens()
    sched = ShardedStreamScheduler(tm, tgen, device="cpu", shards=2, max_slots=4,
                                   prompt_len=PROMPT_LEN, paged=True, page_size=PS)
    sched.lanes[0].stats.completed = 3
    sched.reset_stats()
    assert sched.stats.completed == 0
    assert sched.stats.pages_total == sched.allocator.num_pages - len(sched.lanes)
    assert sched.devices is None and sched.engine is sched.lanes[1].engine


def test_shared_engine_mismatch_raises():
    _, _, tm = models("llada-8b")
    _, tgen = _gens()
    lane = StreamScheduler(tm, tgen, device="cpu", max_slots=2, prompt_len=PROMPT_LEN,
                           paged=True, page_size=PS)
    with pytest.raises(ConfigError, match="shared engine mismatch"):
        StreamScheduler(tm, tgen, device="cpu", max_slots=2, prompt_len=PROMPT_LEN,
                        paged=True, page_size=PS, early_advance=True, engine=lane.engine)
    other = StreamScheduler(tm, tgen, device="cpu", max_slots=2, prompt_len=PROMPT_LEN,
                            paged=True, page_size=PS, engine=lane.engine)
    assert other.engine is lane.engine


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------
LAUNCHER = {
    "defaults": [],
    "shards_paged": ["--shards", "2", "--paged"],
    "shards_dense": ["--shards", "2"],
    "shards_zero": ["--shards", "0", "--paged"],
    "batch_shards": ["--runtime", "batch", "--shards", "2", "--paged"],
    "shards_divide_batch": ["--shards", "3", "--paged"],
    "kv_pages_divide": ["--shards", "2", "--paged", "--kv-pages", "31"],
    "affinity_no_sharing": ["--shards", "2", "--paged", "--placement", "prefix_affinity"],
    "affinity": ["--shards", "2", "--paged", "--placement", "prefix_affinity",
                 "--prefix-sharing"],
    "affinity_one_shard": ["--paged", "--placement", "prefix_affinity", "--prefix-sharing"],
    "disagg": ["--shards", "2", "--paged", "--placement", "disagg"],
    "disagg_one_shard": ["--paged", "--placement", "disagg"],
    "disagg_refresh_shards": ["--shards", "2", "--paged", "--placement", "disagg",
                              "--refresh-shards", "2"],
    "disagg_decode_too_long": ["--shards", "2", "--paged", "--placement", "disagg",
                               "--decode-prompt-len", "64"],
    "disagg_decode": ["--shards", "2", "--paged", "--placement", "disagg",
                      "--decode-prompt-len", "16"],
    "decode_without_disagg": ["--shards", "2", "--paged", "--decode-prompt-len", "16"],
    "batch": ["--runtime", "batch"],
    "batch_preemption": ["--runtime", "batch", "--preemption", "--paged"],
    "batch_priorities": ["--runtime", "batch", "--priority-classes", "2"],
    "batch_deadline": ["--runtime", "batch", "--deadline-s", "5"],
}


class _Accepted(Exception):
    """The reference launcher got past its checks to the model build."""


@pytest.mark.parametrize("case", list(LAUNCHER))
def test_validate_refuses_what_the_reference_refuses(case, monkeypatch):
    import sys

    from repro.launch import serve as jserve

    def reached(*a, **k):
        raise _Accepted

    monkeypatch.setattr(jserve, "build_model", reached)
    monkeypatch.setattr(sys, "argv", ["serve", *LAUNCHER[case]])
    try:
        jserve.main()
        raise AssertionError("the reference launcher neither refused nor built")
    except _Accepted:
        ref_refuses = None
    except JConfigError as e:
        ref_refuses = str(e)
    try:
        serve.validate(serve.parse_args(["--device", "cpu", *LAUNCHER[case]]))
        refuses = None
    except ConfigError as e:
        refuses = str(e)
    assert refuses == ref_refuses


@pytest.mark.parametrize("argv", [
    [],
    ["--placement", "disagg", "--decode-prompt-len", "8"],
], ids=["least_loaded", "disagg"])
def test_launcher_sharded_end_to_end(argv, capsys):
    done = serve.main(["--device", "cpu", "--paged", "--page-size", "8", "--shards", "2",
                       "--requests", "6", "--batch", "4", "--prompt-len", "16",
                       "--gen-length", "16", "--block-length", "8", "--early-advance", *argv])
    assert len(done) == 6 and all(r.error is None and r.output.shape == (16,) for r in done)
    out = capsys.readouterr().out
    assert "served 6 requests" in out
    assert out.count("  shard ") == 2 and "placed=" in out
