"""Preemption and quarantine in the port's scheduler, on the CPU.

* priority preemption: a higher class short of pages or slots spills a
  lower-class resident at its block boundary to host memory; the victim
  resumes later and decodes exactly what an uninterrupted run decodes, the
  port's and the reference's, greedy and sampled (its draw keys depend on
  its seed and lifetime iteration only);
* quarantine: a row that goes non-finite is retired with a typed
  ``PoisonedRequest``, its slot reset and private pages scrubbed, and
  nothing it shared the card with changes;
* the failure gauges.

Reduced LLaDA-8B (4 layers, weights x10) from ``test_torch_engine``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import make_engine as jmake
from repro_torch.core import make_engine as tmake
from repro_torch.runtime import ConfigError, PoisonedRequest, Request, StreamScheduler
from test_torch_engine import gen_configs, models

PL, PS = 16, 8
N_VP = (PL + 16) // PS
ES = dict(mode="es", skip_stages=((1, 0.5),), prompt_refresh_period=8, block_refresh_period=4)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The reduced models' ops are tiny: one intra-op thread runs them as
    fast as eight alone, and keeps them fast when several test workers
    share the CPU (each op's parallel region would wait on busy cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _req(vocab, seed, **kw):
    rng = np.random.default_rng(seed)
    return Request(prompt=rng.integers(3, vocab, PL).astype(np.int32), **kw)


def _offline(tm, tgen, reqs):
    """The port's uninterrupted paged replay of full-length requests."""
    seeds = [r.sample_seed if r.sample_seed is not None else r.request_id for r in reqs]
    eng = tmake(tm, tgen, device="cpu", paged=True, page_size=PS)
    return eng.generate(torch.from_numpy(np.stack([r.prompt for r in reqs])),
                        sample_seeds=torch.tensor(seeds)).numpy()[:, PL:]


def test_preemption_config_validation():
    _, _, tm = models("llada-8b")
    tgen = gen_configs(**ES)[1]
    with pytest.raises(ConfigError, match="requires paged"):
        StreamScheduler(tm, tgen, device="cpu", prompt_len=PL, preemption=True)
    with pytest.raises(ConfigError, match="prefix_sharing"):
        StreamScheduler(tm, tgen, device="cpu", prompt_len=PL, paged=True, page_size=PS,
                        prefix_sharing=True, preemption=True)
    with pytest.raises(ConfigError, match="incompatible"):
        StreamScheduler(tm, dataclasses.replace(tgen, window_blocks=1), device="cpu",
                        prompt_len=PL, paged=True, page_size=PS, lazy_reserve=True,
                        preemption=True)


@pytest.mark.parametrize("sampling", [{}, dict(temperature=0.8)], ids=["greedy", "sampled"])
def test_preempt_spill_resume_equals_uninterrupted(sampling):
    """The pool holds one request: the class-1 arrival can only enter by
    spilling the class-0 resident, which resumes after it."""
    jm, params, tm = models("llada-8b")
    jgen, tgen = gen_configs(**ES, **sampling)
    low = _req(tm.cfg.vocab_size, 0, priority=0, sample_seed=11)
    high = _req(tm.cfg.vocab_size, 1, priority=1, sample_seed=22)
    sched = StreamScheduler(tm, tgen, device="cpu", max_slots=2, prompt_len=PL, paged=True,
                            page_size=PS, kv_pages=N_VP + 1, preemption=True)
    sched.submit(low)
    sched.step()
    assert sched.slot_req[0] is low
    sched.submit(high)
    done = sched.drain()
    assert {r.request_id for r in done} == {low.request_id, high.request_id}
    assert all(r.error is None for r in done)
    assert sched.stats.preemptions >= 1 and sched.stats.pages_spilled >= N_VP
    assert len(sched.stats.resume_waits) == sched.stats.preemptions
    assert high.finish_s <= low.finish_s, "the higher class finishes first"
    assert sched.stats.pages_in_use == 0 and not sched._spilled
    g = sched.stats.gauges()
    assert g["preemptions"] == sched.stats.preemptions and g["resume_p50"] > 0.0
    ref = _offline(tm, tgen, [low, high])
    want = np.asarray(jmake(jm, jgen, paged=True, page_size=PS).generate(
        params, jnp.asarray(np.stack([low.prompt, high.prompt])), jax.random.PRNGKey(0),
        sample_seeds=jnp.asarray([11, 22])))[:, PL:]
    for i, r in enumerate([low, high]):
        np.testing.assert_array_equal(r.output, ref[i], err_msg=f"request {i} vs port offline")
        np.testing.assert_array_equal(r.output, want[i], err_msg=f"request {i} vs reference")


def test_slot_starved_class_preempts_and_both_resume():
    """Two slots, both held by class 0: a class-1 arrival spills the
    youngest at its block boundary for its slot; every request still
    decodes as uninterrupted."""
    _, _, tm = models("llada-8b")
    _, tgen = gen_configs(**ES, temperature=0.8)
    a = _req(tm.cfg.vocab_size, 0, sample_seed=1)
    b = _req(tm.cfg.vocab_size, 1, sample_seed=2)
    c = _req(tm.cfg.vocab_size, 2, priority=1, sample_seed=3)
    sched = StreamScheduler(tm, tgen, device="cpu", max_slots=2, prompt_len=PL, paged=True,
                            page_size=PS, preemption=True)
    sched.submit(a)
    sched.submit(b)
    sched.step()
    sched.submit(c)
    sched.drain()
    assert sched.stats.preemptions == 1 and all(r.error is None for r in (a, b, c))
    assert c.admit_s < a.finish_s, "the arrival did not wait for a retirement"
    ref = _offline(tm, tgen, [a, b, c])
    for i, r in enumerate((a, b, c)):
        np.testing.assert_array_equal(r.output, ref[i])


def test_preemption_needs_a_priority_gap():
    _, _, tm = models("llada-8b")
    _, tgen = gen_configs(**ES)
    a = _req(tm.cfg.vocab_size, 0, priority=1)
    b = _req(tm.cfg.vocab_size, 1, priority=1)
    sched = StreamScheduler(tm, tgen, device="cpu", max_slots=2, prompt_len=PL, paged=True,
                            page_size=PS, kv_pages=N_VP + 1, preemption=True)
    sched.submit(a)
    sched.step()
    sched.submit(b)
    assert len(sched.drain()) == 2 and sched.stats.preemptions == 0
    assert a.finish_s <= b.admit_s


# ---------------------------------------------------------------------------
# quarantine
# ---------------------------------------------------------------------------
def _poison_until_caught(sched, slot=0):
    """Writes NaN into the slot's private current-block page until a step
    reads it."""
    for _ in range(60):
        if sched.stats.poisoned_requests:
            return
        page = int(sched.state.block_tables[slot, int(sched.state.bs[slot]) // PS])
        assert page > 0 and sched.allocator.refcount(page) == 1
        sched.state.cache.k[:, page] = float("nan")
        sched.step()
    raise AssertionError("the detector never fired")


@pytest.mark.parametrize("sampling", [{}, dict(temperature=0.8)], ids=["greedy", "sampled"])
def test_quarantine_isolates_poisoned_row(sampling):
    """The step that sees the NaN no longer raises: the row is retired with
    ``PoisonedRequest``, the bystander decodes as its solo run, and no
    non-finite value is left in the pool."""
    _, _, tm = models("llada-8b")
    _, tgen = gen_configs(**ES, **sampling)
    victim = _req(tm.cfg.vocab_size, 0, sample_seed=1)
    bystander = _req(tm.cfg.vocab_size, 1, sample_seed=2)
    sched = StreamScheduler(tm, tgen, device="cpu", max_slots=2, prompt_len=PL, paged=True,
                            page_size=PS)
    sched.submit(victim)
    sched.submit(bystander)
    sched.step()
    _poison_until_caught(sched)
    assert isinstance(victim.error, PoisonedRequest) and victim.error.slot == 0
    assert victim.output is None and sched.slot_req[0] is None
    assert sched.stats.poisoned_requests == 1 and sched.stats.gauges()["poisoned_requests"] == 1
    assert not bool(sched.state.poisoned.any()) and not bool(sched.state.active[0])
    done = sched.drain()
    assert victim in done and bystander in done and bystander.error is None
    assert sched.stats.completed == 1, "completed counts only clean finishes"
    assert sched.stats.pages_in_use == 0
    np.testing.assert_array_equal(bystander.output, _offline(tm, tgen, [bystander])[0])
    for pool in (sched.state.cache.k, sched.state.cache.v):
        assert torch.isfinite(pool).all(), "NaN bytes survived the quarantine"


def test_quarantine_leaves_shared_pages_and_recycles_the_slot():
    """A greedy cohort member goes non-finite: its private pages are
    scrubbed, the page it shares with its owner is left as it is, and a new
    request admitted into the recycled slot decodes as offline."""
    _, _, tm = models("llada-8b")
    _, tgen = gen_configs(**ES)
    owner = _req(tm.cfg.vocab_size, 3)
    follower = _req(tm.cfg.vocab_size, 3)
    sched = StreamScheduler(tm, tgen, device="cpu", max_slots=2, prompt_len=PL, paged=True,
                            page_size=PS, prefix_sharing=True)
    sched.submit(owner)
    sched.submit(follower)
    sched.step()
    shared = int(sched.state.block_tables[1, 0])
    assert sched.allocator.refcount(shared) == 2
    private = sched.slot_pages[1][: N_VP - PL // PS]
    k_before = sched.state.cache.k[:, shared].clone()
    sched.state.cache.k[:, private[-1]] = float("nan")     # the follower's own page
    sched.state.poisoned[1] = True                          # as the detector sets it
    sched._quarantine([1])
    assert isinstance(follower.error, PoisonedRequest)
    assert sched.allocator.refcount(shared) == 1 and not sched.cohorts
    assert torch.equal(sched.state.cache.k[:, shared], k_before), "a shared page was touched"
    assert (sched.state.cache.k[:, private] == 0).all(), "private pages must be scrubbed"
    fresh = _req(tm.cfg.vocab_size, 4)
    sched.submit(fresh)
    sched.drain()
    assert fresh.error is None and owner.error is None
    np.testing.assert_array_equal(fresh.output, _offline(tm, tgen, [fresh])[0])
    assert sched.stats.pages_in_use == 0


def test_quarantine_of_the_last_resident_reopens_aligned_admission():
    """Without early advance, admission waits for every phase to be 0; a
    quarantine mid-block leaves the phases off the boundary, and the next
    step re-zeroes them so queued work is admitted."""
    _, _, tm = models("llada-8b")
    _, tgen = gen_configs(**ES)
    victim = _req(tm.cfg.vocab_size, 5)
    sched = StreamScheduler(tm, tgen, device="cpu", max_slots=1, prompt_len=PL, paged=True,
                            page_size=PS)
    sched.submit(victim)
    sched.step()
    _poison_until_caught(sched)
    assert sched._phases.any(), "the quarantine should land mid-block"
    queued = _req(tm.cfg.vocab_size, 6)
    sched.submit(queued)
    done = sched.drain(max_steps=200)
    assert queued in done and queued.error is None
    np.testing.assert_array_equal(queued.output, _offline(tm, tgen, [queued])[0])
