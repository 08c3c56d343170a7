"""Lazy page reservation and window growth in the port, on the CPU.

The cases of the reference's ``test_suffix_window.py`` (lazy reservation,
``Request.max_blocks``), each run through the JAX ``StreamScheduler`` and
the port's on the same requests: every request's tokens and the gauges
``pages_deferred``, ``blocks_grown``, ``window_stalls`` (and the sharing
ones where prefix sharing is on) must be equal.

* replay: lazy windowed serving (5 requests over 2 slots, greedy and
  sampled) equals the port's offline windowed replay;
* growth accounting: admission maps the prompt and one window, the frontier
  walks 4 -> 5 -> 6 pages as ``bs`` advances, every page comes back;
* stall, not kill: a 10-page pool stalls the younger row, which resumes;
* ``max_blocks`` caps the output, grows a 1-block hint to 3 blocks on
  demand, and a denied growth is sticky (no growth, no stall);
* lazy reservation with prefix sharing, greedy and sampled;
* construction refuses lazy reservation without the pool, without a window
  and with preemption, and takes it with prefix sharing.

Reduced LLaDA (4 layers, weights x10) from ``test_torch_engine``.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.runtime import Request as JRequest
from repro.runtime import StreamScheduler as JScheduler
from repro_torch.core import make_engine as tmake
from repro_torch.runtime import ConfigError, Request, StreamScheduler
from test_torch_engine import gen_configs, models

PROMPT_LEN, PS = 16, 8
GEN = dict(gen_length=32, block_length=8)        # 4 blocks; 6 virtual pages a request
N_VP = (PROMPT_LEN + GEN["gen_length"]) // PS
GAUGES = ("pages_deferred", "blocks_grown", "window_stalls", "pages_in_use",
          "peak_pages_in_use", "cow_forks", "completed")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The reduced models' ops are tiny: one intra-op thread runs them as
    fast as eight alone, and keeps them fast when several test workers
    share the CPU (each op's parallel region would wait on busy cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _gens(gen_length=GEN["gen_length"], **kw):
    """The reference test's config: es with one skip stage, a prompt refresh
    every 2 iterations, blocks of 8 (4 of them by default)."""
    jgen, tgen = gen_configs(mode="es", skip_stages=((1, 0.5),), prompt_refresh_period=2,
                             block_refresh_period=4, **kw)
    over = dict(gen_length=gen_length, block_length=GEN["block_length"])
    return dataclasses.replace(jgen, **over), dataclasses.replace(tgen, **over)


def _prompts(n, seed=3):
    rng = np.random.default_rng(seed)
    _, _, tm = models("llada-8b")
    return [rng.integers(3, tm.cfg.vocab_size, PROMPT_LEN).astype(np.int32) for _ in range(n)]


def _serve_both(gen_kw, prompts, req_kw=(), **skw):
    """The same requests through the JAX scheduler and the port's (2 slots,
    paged, early advance, lazy reservation): ``(outputs, stats)`` of each,
    outputs in submission order."""
    jm, params, tm = models("llada-8b")
    jgen, tgen = _gens(**gen_kw)
    kw = dict(max_slots=2, prompt_len=PROMPT_LEN, paged=True, page_size=PS,
              early_advance=True, lazy_reserve=True, **skw)
    req_kw = list(req_kw) or [{}] * len(prompts)
    out = {}
    for name, sched, make_req in (
            ("jax", JScheduler(jm, params, jgen, attn_impl="xla", **kw), JRequest),
            ("torch", StreamScheduler(tm, tgen, device="cpu", **kw), Request)):
        reqs = [make_req(prompt=p.copy(), sample_seed=i, **rk)
                for i, (p, rk) in enumerate(zip(prompts, req_kw))]
        for r in reqs:
            sched.submit(r)
        sched.drain()
        assert all(r.error is None and r.output is not None for r in reqs), name
        out[name] = ([r.output for r in reqs], sched)
    (jouts, jsched), (touts, tsched) = out["jax"], out["torch"]
    for i, (want, got) in enumerate(zip(jouts, touts)):
        np.testing.assert_array_equal(got, want, err_msg=f"request {i}")
    jg, tg = jsched.stats.gauges(), tsched.stats.gauges()
    assert {g: tg[g] for g in GAUGES if g in jg} == {g: jg[g] for g in GAUGES if g in jg}
    assert tsched.stats.pages_in_use == 0
    assert tsched.allocator.free_pages == tsched.allocator.num_pages - 1
    return touts, tsched


def _offline(tgen, prompts):
    _, _, tm = models("llada-8b")
    eng = tmake(tm, tgen, device="cpu", paged=True, page_size=PS)
    return eng.generate(torch.from_numpy(np.stack(prompts)),
                        sample_seeds=torch.arange(len(prompts))).numpy()


@pytest.mark.parametrize("temperature", [0.0, 0.7])
def test_lazy_serving_matches_reference_and_offline(temperature):
    prompts = _prompts(5)
    outs, sched = _serve_both(dict(window_blocks=1, temperature=temperature), prompts)
    assert sched.stats.pages_deferred > 0
    assert len(np.unique(np.concatenate(outs))) >= 10, "degenerate outputs"
    want = _offline(_gens(window_blocks=1, temperature=temperature)[1], prompts)
    for i, o in enumerate(outs):
        np.testing.assert_array_equal(o, want[i, PROMPT_LEN:], err_msg=f"request {i}")


def test_growth_accounting_matches_reference():
    """Admission maps prompt (2 pages) + one window (2), defers 2 of 6; the
    frontier walks page by page as bs advances; nothing stalls."""
    jm, params, tm = models("llada-8b")
    jgen, tgen = _gens(window_blocks=1)
    kw = dict(max_slots=2, prompt_len=PROMPT_LEN, paged=True, page_size=PS,
              early_advance=True, lazy_reserve=True)
    walks = []
    for sched, make_req in ((JScheduler(jm, params, jgen, attn_impl="xla", **kw), JRequest),
                            (StreamScheduler(tm, tgen, device="cpu", **kw), Request)):
        for i, p in enumerate(_prompts(2)):
            sched.submit(make_req(prompt=p, sample_seed=i))
        sched.step()
        assert sched.slot_frontier[0] == 4 and tuple(sched.slot_extent[0]) == (0, 6)
        assert sched.stats.pages_deferred == 4 and sched.stats.pages_in_use == 8
        frontiers = [sched.slot_frontier[0]]
        while sched.has_work():
            sched.step()
            frontiers.append(sched.slot_frontier[0])
        walks.append(frontiers)
        assert sched.stats.window_stalls == 0 and sched.stats.pages_in_use == 0
    assert walks[1] == walks[0] and set(walks[1]) == {4, 5, 6}


def test_stall_not_kill_matches_reference():
    prompts = _prompts(2)
    outs, sched = _serve_both(dict(window_blocks=1), prompts, kv_pages=11)
    assert sched.stats.window_stalls >= 1 and sched.stats.completed == 2
    want = _offline(_gens(window_blocks=1)[1], prompts)
    for i, o in enumerate(outs):
        np.testing.assert_array_equal(o, want[i, PROMPT_LEN:])


@pytest.mark.parametrize("case", ["hard_cap", "on_demand_growth", "sticky_denial"])
def test_max_blocks_matches_reference(case):
    n, req_kw, skw, n_blocks = {
        "hard_cap": (1, [dict(max_blocks=2)], {}, 2),
        "on_demand_growth": (1, [dict(max_new_tokens=8, max_blocks=3)], {}, 3),
        # each 2-block extent maps 4 pages: an 8-page pool holds both with
        # no slack, so both final-block growth asks are denied
        "sticky_denial": (2, [dict(max_new_tokens=16, max_blocks=4)] * 2,
                          dict(kv_pages=9), 2),
    }[case]
    prompts = _prompts(n)
    outs, sched = _serve_both(dict(window_blocks=1), prompts, req_kw, **skw)
    assert all(o.shape == (n_blocks * GEN["block_length"],) for o in outs)
    if case == "on_demand_growth":
        assert sched.stats.blocks_grown >= 1
    if case == "sticky_denial":
        assert sched.stats.blocks_grown == 0 and sched.stats.window_stalls == 0
    if case != "hard_cap":
        want = _offline(_gens(window_blocks=1, gen_length=n_blocks * GEN["block_length"])[1],
                        prompts)
        for i, o in enumerate(outs):
            np.testing.assert_array_equal(o, want[i, PROMPT_LEN:])


@pytest.mark.parametrize("temperature", [0.0, 0.7])
def test_lazy_with_prefix_sharing_matches_reference(temperature):
    prompts = _prompts(2)
    prompts[1] = prompts[0].copy()
    outs, sched = _serve_both(dict(window_blocks=1, temperature=temperature), prompts,
                              prefix_sharing=True)
    assert sched.stats.pages_deferred > 0
    if temperature > 0:
        assert sched.stats.cow_forks == PROMPT_LEN // PS
    else:
        assert sched.stats.cow_forks == 0 and sched.stats.peak_pages_in_use < 2 * N_VP


def test_lazy_reserve_construction():
    _, _, tm = models("llada-8b")
    tgen = _gens(window_blocks=1)[1]
    kw = dict(device="cpu", prompt_len=PROMPT_LEN, page_size=PS, lazy_reserve=True)
    with pytest.raises(ConfigError, match="requires paged"):
        StreamScheduler(tm, tgen, **kw)
    with pytest.raises(ConfigError, match="finite window"):
        StreamScheduler(tm, _gens()[1], paged=True, **kw)
    with pytest.raises(ConfigError, match="incompatible"):
        StreamScheduler(tm, tgen, paged=True, preemption=True, **kw)
    sched = StreamScheduler(tm, tgen, paged=True, prefix_sharing=True, **kw)
    assert sched.lazy_reserve and sched.prefix_sharing
