"""The port's serving path against the JAX reference's, on the CPU.

``DiffusionEngine.step`` over an ``EngineState`` and the ``StreamScheduler``
on top of it, on reduced LLaDA-8B (4 layers, as in ``test_torch_engine``):

* the state after each step of a mixed-phase trace (rows at different
  phases, so one step runs several passes) equals the reference engine's:
  counters and tokens exact, floats within 1e-4 at the init scale;
* every request of a staggered trace gets the reference scheduler's tokens,
  dense and paged, with both ``early_advance`` settings (weights x10 for
  non-degenerate tokens), equals the port's own offline replay, and every
  page returns to the allocator;
* what the port leaves out raises, the launcher takes the sharing and
  preemption flags, and refuses what the reference's launcher refuses.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import make_engine as jmake
from repro.runtime import Request as JRequest
from repro.runtime import StreamScheduler as JScheduler
from repro_torch.core import make_engine as tmake
from repro_torch.launch import serve
from repro_torch.runtime import (
    ConfigError,
    DeadlineUnmeetable,
    DrainStalled,
    LedgerError,
    PageAllocator,
    Request,
    StreamScheduler,
)
from test_torch_engine import gen_configs, models

PL, PS = 16, 8
# 8 steps per block: phase 0 a full refresh, 4 a partial one, 3 and 6 block
# refreshes, the rest skip decodes
SERVE = dict(mode="es", skip_stages=((1, 0.5), (2, 0.5)), cache_prompt_interval=2,
             prompt_refresh_period=4, block_refresh_period=3)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The reduced models' ops are tiny: one intra-op thread runs them as
    fast as eight alone, and keeps them fast when several test workers
    share the CPU (each op's parallel region would wait on busy cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _row(tm, prompt):
    row = np.full((PL + 16,), tm.cfg.vocab_size, np.int32)
    row[:PL] = 0
    row[PL - len(prompt):PL] = prompt
    return row


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_engine_state_steps_match_reference(paged):
    """Slot 0 is admitted at step 0, slot 1 (a 6-token prompt, so a pad-only
    page stays unmapped) at step 2, slot 2 stays idle.  After each of seven
    steps the port's state equals the reference's."""
    jm, params, tm = models("llada-8b", scale=1.0)
    jgen, tgen = gen_configs(**SERVE)
    ekw = dict(paged=True, page_size=PS) if paged else {}
    jeng = jmake(jm, jgen, attn_impl="pallas", importance_impl="pallas", early_advance=True,
                 **ekw)
    teng = tmake(tm, tgen, device="cpu", early_advance=True, **ekw)
    jst = jeng.init_engine_state(3, PL, jax.random.PRNGKey(0))
    tst = teng.init_engine_state(3, PL)
    rng = np.random.default_rng(5)
    admit = {0: (0, rng.integers(3, tm.cfg.vocab_size, 16), [1, 2, 3, 4]),
             2: (1, rng.integers(3, tm.cfg.vocab_size, 6), [-1, 7, 5, 6])}
    for step in range(7):
        if step in admit:
            slot, prompt, pages = admit[step]
            row, start = _row(tm, prompt), (PL - len(prompt) if paged else 0)
            jst = jst._replace(
                tokens=jst.tokens.at[slot].set(row), bs=jst.bs.at[slot].set(PL),
                blocks_left=jst.blocks_left.at[slot].set(2), phase=jst.phase.at[slot].set(0),
                iters=jst.iters.at[slot].set(0), active=jst.active.at[slot].set(True),
                prompt_start=jst.prompt_start.at[slot].set(start))
            tst.tokens[slot] = torch.from_numpy(row)
            for name, value in (("bs", PL), ("blocks_left", 2), ("phase", 0), ("iters", 0),
                                ("active", True), ("prompt_start", start)):
                getattr(tst, name)[slot] = value
            if paged:
                jst = jst._replace(block_tables=jst.block_tables.at[slot].set(np.int32(pages)))
                tst.block_tables[slot] = torch.tensor(pages, dtype=torch.int32)
        jst = jeng.step(params, jst)
        tst = teng.step(tst)
        for name in ("tokens", "bs", "blocks_left", "phase", "iters", "active", "pred",
                     "cache_refreshed", "cache_eligible", "poisoned"):
            np.testing.assert_array_equal(getattr(tst, name).numpy(),
                                          np.asarray(getattr(jst, name)), err_msg=name)
        for name in ("conf", "feat", "conf_full"):
            np.testing.assert_allclose(getattr(tst, name).numpy(),
                                       np.asarray(getattr(jst, name)), atol=1e-4, rtol=0,
                                       err_msg=name)
        for th, jh in zip(tst.hidden, jst.hidden):
            np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=1e-4, rtol=0)
        # page 0 is the garbage page: the reference writes masked rows there
        lo = 1 if paged else 0
        for tc, jc in ((tst.cache.k, jst.caches["kv"]["0"].k),
                       (tst.cache.v, jst.caches["kv"]["0"].v)):
            np.testing.assert_allclose(tc.numpy()[:, lo:], np.asarray(jc)[:, lo:], atol=1e-4,
                                       rtol=0)
    assert set(teng.pass_counts.values()) != {0} and all(teng.pass_counts.values())


# (step at which it arrives, prompt length, max_new_tokens)
TRACE = [(0, 16, None), (0, 5, 8), (0, 12, None), (2, 9, None), (5, 16, 8), (6, 3, None)]


def _serve(make_sched, make_req, vocab):
    rng = np.random.default_rng(11)
    prompts = [rng.integers(3, vocab, n).astype(np.int32) for _, n, _ in TRACE]
    sched = make_sched()
    reqs = [make_req(prompt=p.copy(), max_new_tokens=m) for p, (_, _, m) in zip(prompts, TRACE)]
    step = 0
    while step <= TRACE[-1][0] or sched.has_work():
        for (at, _, _), r in zip(TRACE, reqs):
            if at == step:
                sched.submit(r)
        sched.step()
        step += 1
    return prompts, reqs, sched


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
@pytest.mark.parametrize("early_advance", [True, False], ids=["early", "aligned"])
def test_scheduler_matches_reference_and_offline_replay(paged, early_advance):
    jm, params, tm = models("llada-8b")
    jgen, tgen = gen_configs(parallel_decoding=True, pd_threshold=0.5, **SERVE)
    kw = dict(max_slots=3, prompt_len=PL, paged=paged, page_size=PS,
              early_advance=early_advance)
    _, jreqs, _ = _serve(lambda: JScheduler(jm, params, jgen, attn_impl="xla", **kw),
                              JRequest, tm.cfg.vocab_size)
    prompts, reqs, sched = _serve(lambda: StreamScheduler(tm, tgen, device="cpu", **kw),
                                  Request, tm.cfg.vocab_size)
    for r, jr in zip(reqs, jreqs):
        assert r.error is None and r.output is not None
        np.testing.assert_array_equal(r.output, jr.output)
    # the step a token unmasks may differ where two confidences tie to 1e-6
    # (a block may then finish one step apart), so the gauges are not
    # compared with the reference's
    assert (sched.stats.early_advances > 0) == early_advance
    assert 0.0 < sched.stats.cache_hit_fraction < 1.0
    assert len({len(np.unique(r.output)) for r in reqs}) > 1
    assert all(sched.engine.pass_counts.values())
    # the port's offline replay of each full-length request: its prompt
    # left-padded, pad rows masked when paged (dense serving attends them)
    full = [i for i, (_, _, m) in enumerate(TRACE) if m is None]
    batch = np.stack([np.concatenate([np.zeros(PL - len(prompts[i]), np.int32), prompts[i]])
                      for i in full])
    start = torch.tensor([PL - len(prompts[i]) if paged else 0 for i in full])
    offline = tmake(tm, tgen, device="cpu", **(dict(paged=True, page_size=PS) if paged else {}))
    replay = offline.generate(torch.from_numpy(batch), prompt_start=start).numpy()
    for j, i in enumerate(full):
        np.testing.assert_array_equal(reqs[i].output, replay[j, PL:])
    if paged:
        assert sched.stats.pages_in_use == 0 and sched.stats.peak_pages_in_use > 0
        assert sched.allocator.free_pages == sched.allocator.num_pages - 1
        assert (sched.state.block_tables == -1).all()


def test_streaming_callbacks_and_gauges():
    _, _, tm = models("llada-8b")
    _, tgen = gen_configs(**SERVE)
    seen = []
    sched = StreamScheduler(tm, tgen, device="cpu", max_slots=2, prompt_len=PL, paged=True,
                            page_size=PS, early_advance=True,
                            stream_cb=lambda r, bi, blk: seen.append((r.request_id, bi)))
    reqs = [Request(prompt=np.arange(3, 3 + n, dtype=np.int32)) for n in (16, 4, 9)]
    for r in reqs:
        sched.submit(r)
    done = sched.drain()
    assert {r.request_id for r in done} == {r.request_id for r in reqs}
    assert sorted(seen) == sorted((r.request_id, bi) for r in reqs for bi in range(2))
    # a 4-token prompt maps 3 of the 4 pages (its pad-only page stays unmapped)
    assert sched.stats.peak_pages_in_use == 4 + 3
    assert sched.stats.resident_peak == 2 and sched.stats.completed == 3
    assert sched.stats.goodput > 0 and sched.stats.latency_pct(95) > 0


@pytest.mark.parametrize("kw", [dict(lazy_reserve=True)], ids=lambda k: next(iter(k)))
def test_serving_options_outside_the_slice_raise(kw):
    """Lazy reservation is in the port, but, as in the reference, needs a
    finite window (none here)."""
    _, _, tm = models("llada-8b")
    with pytest.raises(ConfigError, match="finite window"):
        StreamScheduler(tm, gen_configs(**SERVE)[1], device="cpu", paged=True, page_size=PS,
                        prompt_len=PL, **kw)


def test_drain_watchdog_deadline_and_ledger():
    _, _, tm = models("llada-8b")
    sched = StreamScheduler(tm, gen_configs(**SERVE)[1], device="cpu", max_slots=1,
                            prompt_len=PL)
    sched.submit(Request(prompt=np.arange(3, 19, dtype=np.int32)))
    late = Request(prompt=np.arange(3, 9, dtype=np.int32), deadline_s=-1.0)
    sched.submit(late)
    assert isinstance(late.error, DeadlineUnmeetable) and sched.stats.deadline_rejects == 1
    with pytest.raises(DrainStalled, match="max_steps=2"):
        sched.drain(max_steps=2)
    alloc = PageAllocator(4)
    pages = alloc.alloc(3)
    assert pages == [1, 2, 3] and alloc.alloc(1) is None
    alloc.release(pages)
    with pytest.raises(LedgerError):
        alloc.release([2])


def test_serve_launcher_on_the_cpu(capsys):
    done = serve.main(["--device", "cpu", "--requests", "3", "--batch", "2",
                       "--gen-length", "16", "--block-length", "8", "--prompt-len", "16",
                       "--paged", "--page-size", "8", "--early-advance",
                       "--prompt-refresh-period", "4", "--cache-prompt-interval", "2",
                       "--parallel-decoding", "--priority-classes", "2", "--deadline-s", "600",
                       "--stream-print"])
    assert len(done) == 3 and all(r.output is not None and r.output.shape == (16,)
                                  for r in done)
    assert sorted(r.priority for r in done) == [0, 0, 1]
    out = capsys.readouterr().out
    assert "served 3 requests" in out and "cache_hit=" in out and "peak_pages=" in out
    assert out.count("[stream]") == 6 and "deadline_rejects=0" in out


@pytest.mark.parametrize("argv,out", [
    (["--prefix-sharing", "--dup-prompts", "--requests", "4", "--batch", "4"],
     "cow_forks=0"),
    (["--preemption", "--priority-classes", "2", "--requests", "4", "--batch", "2",
      "--kv-pages", "5"], "preemptions="),
], ids=["prefix_sharing", "preemption"])
def test_serve_launcher_sharing_and_preemption(argv, out, capsys):
    done = serve.main(["--device", "cpu", "--gen-length", "16", "--block-length", "8",
                       "--prompt-len", "16", "--paged", "--page-size", "8", *argv])
    assert len(done) == 4 and all(r.error is None and r.output.shape == (16,) for r in done)
    if "--dup-prompts" in argv:
        assert len({r.prompt.tobytes() for r in done}) == 1
    printed = capsys.readouterr().out
    assert "served 4 requests" in printed and out in printed


@pytest.mark.parametrize("flags,why", [
    (["--preemption"], "requires --paged"),
    (["--prefix-sharing"], "requires --paged"),
    (["--paged", "--preemption", "--prefix-sharing"], "incompatible"),
], ids=["preemption_dense", "sharing_dense", "preemption_and_sharing"])
def test_serve_launcher_refuses_bad_combinations(flags, why):
    with pytest.raises(ConfigError, match=why):
        serve.main(["--device", "cpu", *flags])


@pytest.mark.parametrize("flag,why", [(["--lazy-reserve"], "requires --paged"),
                                      (["--gather-refresh"], "requires --paged"),
                                      (["--shards", "2"], "requires --paged"),
                                      (["--runtime", "batch", "--shards", "2"],
                                       "needs the stream runtime")],
                         ids=["--lazy-reserve", "--gather-refresh", "--shards", "--runtime"])
def test_serve_launcher_flags_outside_the_slice_raise(flag, why):
    """Every flag of the reference's launcher is in the port; each of these
    raises as the reference's does: ``--lazy-reserve``, ``--gather-refresh``
    and ``--shards 2`` need ``--paged``, and the sharded scheduler needs the
    stream runtime."""
    with pytest.raises(ConfigError, match=why):
        serve.main(["--device", "cpu", *flag])
