"""The port's Jamba hybrid served on the paged pool, against the JAX reference's
scheduler, on the CPU.

Reduced Jamba (16 layers, as in ``test_torch_hybrid``) on 3 slots and a
tight pool of 9 pages (two full-length requests), early advance on.  Pages
hold the K/V of the two attention layers; each slot keeps its own caches of
the 14 SSM layers.  One reference engine serves both greedy cases on 3
slots (its step compiles once):

* the engine state after each step of a mixed-phase trace equals the
  reference engine's: counters and tokens exact, floats, the K/V pool pages
  and every SSM plane within 1e-4 at the init scale;
* a staggered paged trace (weights x10) gets the reference scheduler's
  tokens;
* a sampled trace of duplicate cohorts with prefix sharing forks K/V pages
  (``cow_forks > 0``) and gets the reference's tokens and fork count;
* preemption on one slot and a pool of one request spills the resident
  (``preemptions >= 1``); both requests get the reference scheduler's
  tokens, and each equals its uninterrupted run offline;
* the launcher serves ``--arch jamba-v0.1-52b --paged``.

The port's offline replay of a trace is not compared: MoE picks that drop
at capacity depend on the other rows of a routing group, so a request's
tokens depend on what shares its passes, in both packages.  On one slot a
request shares its passes with nothing, so there it replays offline at
batch 1.
"""
import functools

import jax
import numpy as np
import pytest
import torch

from repro.core import make_engine as jmake
from repro.runtime import Request as JRequest
from repro.runtime import StreamScheduler as JScheduler
from repro_torch.core import make_engine as tmake
from repro_torch.launch import serve
from repro_torch.runtime import Request, StreamScheduler
from test_torch_hybrid import STAGES, gen_configs, models

PL, PS, SLOTS = 16, 8, 3
N_VP = (PL + 16) // PS
POOL = 2 * N_VP + 1
# 8 steps per block: phase 0 and 4 prompt refreshes, 3 and 6 block
# refreshes, the rest skip decodes; parallel decoding (at x10 weights) ends
# blocks early, so rows advance at their own phases
SERVE = dict(mode="es", skip_stages=STAGES, prompt_refresh_period=4, block_refresh_period=3,
             parallel_decoding=True, pd_threshold=0.5)
PAGED = dict(paged=True, page_size=PS, kv_pages=POOL, early_advance=True)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the reduced model's ops are tiny, and several
    test workers share the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def engines(temperature=0.0, pool=POOL):
    """(reference engine, reference gen, port gen): one jitted reference
    step for every scheduler of a gen config and pool."""
    jgen, tgen = gen_configs(**SERVE, temperature=temperature)
    jm = models()[0]
    return jmake(jm, jgen, importance_impl="pallas", **dict(PAGED, kv_pages=pool)), jgen, tgen


def _schedulers(temperature=0.0, slots=SLOTS, pool=POOL, **kw):
    """A reference and a port scheduler on the shared engine's settings."""
    jm, params, tm, _ = models()
    jeng, jgen, tgen = engines(temperature, pool)
    skw = dict(max_slots=slots, prompt_len=PL, paged=True, page_size=PS, kv_pages=pool,
               early_advance=True, **kw)
    return (JScheduler(jm, params, jgen, engine=jeng, **skw),
            StreamScheduler(tm, tgen, device="cpu", **skw))


def _row(vocab, prompt):
    row = np.full((PL + 16,), vocab, np.int32)
    row[:PL] = 0
    row[PL - len(prompt):PL] = prompt
    return row


def test_engine_state_steps_match_reference():
    """Slot 0 is admitted at step 0, slot 1 (a 6-token prompt, so a pad-only
    page stays unmapped) at step 2, slot 2 stays idle: after each of nine
    steps the port's state, pool pages and SSM planes equal the
    reference's."""
    jm, params, tm, _ = models(1.0)
    jeng, _, tgen = engines()
    teng = tmake(tm, tgen, device="cpu", **PAGED)
    jst = jeng.init_engine_state(SLOTS, PL, jax.random.PRNGKey(0))
    tst = teng.init_engine_state(SLOTS, PL)
    rng = np.random.default_rng(5)
    admit = {0: (0, rng.integers(3, tm.cfg.vocab_size, 16), [1, 2, 3, 4]),
             2: (1, rng.integers(3, tm.cfg.vocab_size, 6), [-1, 7, 5, 6])}
    for step in range(9):
        if step in admit:
            slot, prompt, pages = admit[step]
            row, start = _row(tm.cfg.vocab_size, prompt), PL - len(prompt)
            jst = jst._replace(
                tokens=jst.tokens.at[slot].set(row), bs=jst.bs.at[slot].set(PL),
                blocks_left=jst.blocks_left.at[slot].set(2), phase=jst.phase.at[slot].set(0),
                iters=jst.iters.at[slot].set(0), active=jst.active.at[slot].set(True),
                prompt_start=jst.prompt_start.at[slot].set(start),
                block_tables=jst.block_tables.at[slot].set(np.int32(pages)))
            tst.tokens[slot] = torch.from_numpy(row)
            for name, value in (("bs", PL), ("blocks_left", 2), ("phase", 0), ("iters", 0),
                                ("active", True), ("prompt_start", start)):
                getattr(tst, name)[slot] = value
            tst.block_tables[slot] = torch.tensor(pages, dtype=torch.int32)
        jst = jeng.step(params, jst)
        tst = teng.step(tst)
        for name in ("tokens", "bs", "blocks_left", "phase", "iters", "active", "pred",
                     "poisoned"):
            np.testing.assert_array_equal(getattr(tst, name).numpy(),
                                          np.asarray(getattr(jst, name)),
                                          err_msg=f"step {step}: {name}")
        np.testing.assert_allclose(tst.conf.numpy(), np.asarray(jst.conf), atol=1e-4, rtol=0)
        for th, jh in zip(tst.hidden, jst.hidden):
            np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=1e-4, rtol=0)
        jc = jst.caches
        for l in range(tm.cfg.n_layers):
            g, j = divmod(l, 8)
            if l in tm.kv_plane:
                # page 0 is the garbage page: the reference writes masked rows there
                pairs = ((tst.cache.kv.k[tm.kv_plane[l]], jc["kv"][str(j)].k[g]),
                         (tst.cache.kv.v[tm.kv_plane[l]], jc["kv"][str(j)].v[g]))
                pairs = tuple((t[1:], np.asarray(r)[1:]) for t, r in pairs)
            else:
                i = tm.ssm_plane[l]
                pairs = ((tst.cache.ssm.state[i], jc["ssm"][str(j)].state[g]),
                         (tst.cache.ssm.conv_tail[i], jc["ssm"][str(j)].conv_tail[g]),
                         (tst.cache.ssm.ssmh[i], jc["ssmh"][str(j)][g]))
            for t, r in pairs:
                np.testing.assert_allclose(t.numpy(), np.asarray(r), atol=1e-4, rtol=0,
                                           err_msg=f"step {step}: layer {l}")
    assert all(teng.pass_counts[k] for k in ("skip", "noskip", "prefill"))


# (step at which it arrives, prompt length, max_new_tokens)
TRACE = [(0, 16, None), (0, 5, 8), (0, 12, None), (2, 9, None), (5, 16, 8), (6, 3, None)]


def _drive(sched, reqs, arrivals):
    step = 0
    while step <= max(arrivals) or sched.has_work():
        for at, r in zip(arrivals, reqs):
            if at == step:
                sched.submit(r)
        sched.step()
        step += 1
    assert all(r.error is None and r.output is not None for r in reqs)
    return [r.output for r in reqs]


def test_paged_trace_matches_reference():
    jsched, sched = _schedulers()
    tm = models()[2]
    rng = np.random.default_rng(11)
    prompts = [rng.integers(3, tm.cfg.vocab_size, n).astype(np.int32) for _, n, _ in TRACE]
    arrivals = [at for at, _, _ in TRACE]
    want = _drive(jsched, [JRequest(prompt=p.copy(), max_new_tokens=m)
                           for p, (_, _, m) in zip(prompts, TRACE)], arrivals)
    got = _drive(sched, [Request(prompt=p.copy(), max_new_tokens=m)
                         for p, (_, _, m) in zip(prompts, TRACE)], arrivals)
    for i, (x, y) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(x, y, err_msg=f"request {i}")
    assert sched.stats.early_advances > 0 and len({len(np.unique(o)) for o in got}) > 1
    assert all(sched.engine.pass_counts[k] for k in ("skip", "noskip", "prefill"))
    assert sched.allocator.free_pages == sched.allocator.num_pages - 1
    assert sched.stats.peak_pages_in_use == POOL - 1, "the pool gates admission"


def test_sampled_prefix_sharing_forks_and_matches_reference():
    """Two sampled cohorts (2 duplicates each of a 16- and a 12-token
    prompt): followers map the owner's full prompt pages, then fork them
    before their first refresh after the draws diverge."""
    jsched, sched = _schedulers(temperature=0.8, prefix_sharing=True)
    tm = models()[2]
    rng = np.random.default_rng(2)
    a, b = (rng.integers(3, tm.cfg.vocab_size, n).astype(np.int32) for n in (16, 12))
    prompts = [a, a, b, b]
    arrivals = [0, 0, 0, 0]
    want = _drive(jsched, [JRequest(prompt=p.copy(), sample_seed=100 + i)
                           for i, p in enumerate(prompts)], arrivals)
    got = _drive(sched, [Request(prompt=p.copy(), sample_seed=100 + i)
                         for i, p in enumerate(prompts)], arrivals)
    for i, (x, y) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(x, y, err_msg=f"request {i}")
    assert sched.stats.cow_forks > 0 and sched.stats.cow_forks == jsched.stats.cow_forks
    assert got[0].tobytes() != got[1].tobytes(), "the seeds must diverge"
    assert sched.stats.pages_in_use == 0 and not sched.cohorts


def test_preemption_on_a_tight_pool_matches_reference_and_uninterrupted():
    """One slot and a pool of one full-length request: a class-1 arrival
    spills the class-0 resident at its block boundary; it resumes at phase
    0, whose prompt refresh rebuilds its SSM caches, and decodes what it
    would have alone."""
    tm = models()[2]
    rng = np.random.default_rng(7)
    prompts = [rng.integers(3, tm.cfg.vocab_size, PL).astype(np.int32) for _ in range(2)]
    outs = []
    for make_req, sched in zip((JRequest, Request),
                               _schedulers(slots=1, pool=N_VP + 1, preemption=True)):
        reqs = [make_req(prompt=p.copy(), priority=c) for p, c in zip(prompts, (0, 1))]
        outs.append(_drive(sched, reqs, [0, 3]))
        assert sched.stats.preemptions >= 1 and sched.stats.pages_spilled >= N_VP
        assert reqs[1].finish_s <= reqs[0].finish_s
    want, got = outs
    offline = tmake(tm, engines()[2], device="cpu", paged=True, page_size=PS)
    for i in range(2):
        np.testing.assert_array_equal(got[i], want[i], err_msg=f"request {i} vs reference")
        alone = offline.generate(torch.from_numpy(prompts[i][None])).numpy()[0, PL:]
        np.testing.assert_array_equal(got[i], alone, err_msg=f"request {i} vs uninterrupted")


def test_serve_launcher_with_jamba_paged(capsys):
    done = serve.main(["--device", "cpu", "--arch", "jamba-v0.1-52b", "--requests", "3",
                       "--batch", "2", "--gen-length", "16", "--block-length", "8",
                       "--prompt-len", "16", "--paged", "--page-size", "8",
                       "--early-advance", "--prompt-refresh-period", "4"])
    assert len(done) == 3 and all(r.error is None and r.output.shape == (16,) for r in done)
    assert "served 3 requests" in capsys.readouterr().out
