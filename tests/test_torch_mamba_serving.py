"""The port's Mamba-2 serving path against the JAX reference's, on the CPU.

Reduced mamba2-370m (4 layers, as in ``test_torch_mamba``) on dense slots:

* the engine state after each step of a mixed-phase trace (rows at
  different phases, so one step runs several passes, each writing the SSM
  caches of its own rows only) equals the reference engine's: counters and
  tokens exact, floats and the three SSM caches within 1e-4 at the init
  scale;
* every request of a staggered trace gets the reference scheduler's tokens,
  with early advance and without (weights x10), and equals the port's own
  offline replay;
* on the paged pool (which holds no plane on a pure SSM stack) the
  offline engine, a staggered trace, sampled prefix sharing and preemption
  get the reference's tokens;
* what the reference refuses on an SSM stack (the adaptive cache,
  ``gather_refresh``) raises, saying so.
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
from repro_torch.runtime import ConfigError, Request, StreamScheduler
from test_torch_mamba import STAGES, _gen_configs, models

PL = 16
# 8 steps per block: phase 0 and 4 prompt refreshes, 3 and 6 block
# refreshes, the rest skip decodes
SERVE = dict(mode="es", skip_stages=STAGES, prompt_refresh_period=4, block_refresh_period=3)
TRACE = [(0, 16, None), (0, 5, 8), (0, 12, None), (2, 9, None), (5, 16, 8), (6, 3, None)]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The reduced models' ops are tiny: one intra-op thread runs them as
    fast as eight alone, and keeps them fast when several test workers
    share the CPU (each op's parallel region would wait on busy cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _row(vocab, prompt):
    row = np.full((PL + 16,), vocab, np.int32)
    row[:PL] = 0
    row[PL - len(prompt):PL] = prompt
    return row


def test_engine_state_steps_match_reference():
    """Slot 0 is admitted at step 0, slot 1 at step 2, slot 2 stays idle:
    after each of nine steps the port's state and SSM caches equal the
    reference's."""
    jm, params, tm = models(1.0)
    jgen, tgen = _gen_configs(**SERVE)
    jeng = jmake(jm, jgen, importance_impl="pallas", early_advance=True)
    teng = tmake(tm, tgen, device="cpu", early_advance=True)
    jst = jeng.init_engine_state(3, PL, jax.random.PRNGKey(0))
    tst = teng.init_engine_state(3, PL)
    rng = np.random.default_rng(5)
    admit = {0: (0, rng.integers(3, tm.cfg.vocab_size, 16)),
             2: (1, rng.integers(3, tm.cfg.vocab_size, 6))}
    for step in range(9):
        if step in admit:
            slot, prompt = admit[step]
            row = _row(tm.cfg.vocab_size, prompt)
            jst = jst._replace(
                tokens=jst.tokens.at[slot].set(row), bs=jst.bs.at[slot].set(PL),
                blocks_left=jst.blocks_left.at[slot].set(2), phase=jst.phase.at[slot].set(0),
                iters=jst.iters.at[slot].set(0), active=jst.active.at[slot].set(True))
            tst.tokens[slot] = torch.from_numpy(row)
            for name, value in (("bs", PL), ("blocks_left", 2), ("phase", 0), ("iters", 0),
                                ("active", True)):
                getattr(tst, name)[slot] = value
        jst = jeng.step(params, jst)
        tst = teng.step(tst)
        for name in ("tokens", "bs", "blocks_left", "phase", "iters", "active", "pred",
                     "poisoned"):
            np.testing.assert_array_equal(getattr(tst, name).numpy(),
                                          np.asarray(getattr(jst, name)), err_msg=name)
        np.testing.assert_allclose(tst.conf.numpy(), np.asarray(jst.conf), atol=1e-4, rtol=0)
        for th, jh in zip(tst.hidden, jst.hidden):
            np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=1e-4, rtol=0)
        for name, tc, jc in (("state", tst.cache.state, jst.caches["ssm"]["0"].state),
                             ("conv_tail", tst.cache.conv_tail,
                              jst.caches["ssm"]["0"].conv_tail),
                             ("ssmh", tst.cache.ssmh, jst.caches["ssmh"]["0"])):
            np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-4, rtol=0,
                                       err_msg=f"step {step}: {name}")
    assert all(teng.pass_counts[k] for k in ("skip", "noskip", "prefill"))


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


@pytest.mark.parametrize("early_advance", [True, False], ids=["early", "aligned"])
def test_scheduler_matches_reference_and_offline_replay(early_advance):
    jm, params, tm = models()
    jgen, tgen = _gen_configs(parallel_decoding=True, pd_threshold=0.5, **SERVE)
    kw = dict(max_slots=3, prompt_len=PL, early_advance=early_advance)
    _, jreqs, _ = _serve(lambda: JScheduler(jm, params, jgen, **kw), JRequest, tm.cfg.vocab_size)
    prompts, reqs, sched = _serve(lambda: StreamScheduler(tm, tgen, device="cpu", **kw),
                                  Request, tm.cfg.vocab_size)
    for r, jr in zip(reqs, jreqs):
        assert r.error is None and r.output is not None
        np.testing.assert_array_equal(r.output, jr.output)
    assert (sched.stats.early_advances > 0) == early_advance
    assert len({len(np.unique(r.output)) for r in reqs}) > 1
    assert all(sched.engine.pass_counts[k] for k in ("skip", "noskip", "prefill"))
    # the port's offline replay of each full-length request, its prompt
    # left-padded (dense serving attends the pad rows)
    full = [i for i, (_, _, m) in enumerate(TRACE) if m is None]
    batch = np.stack([np.concatenate([np.zeros(PL - len(prompts[i]), np.int32), prompts[i]])
                      for i in full])
    replay = tmake(tm, tgen, device="cpu").generate(torch.from_numpy(batch)).numpy()
    for j, i in enumerate(full):
        np.testing.assert_array_equal(reqs[i].output, replay[j, PL:])


def test_paged_ssm_engine_generate_matches_reference():
    """The paged engine on a pure SSM stack (a pool with no plane): es
    tokens equal the reference's paged engine's and the port's dense one's."""
    jm, params, tm = models()
    jgen, tgen = _gen_configs(mode="es", skip_stages=STAGES)
    prompt = np.random.default_rng(3).integers(3, tm.cfg.vocab_size, (2, PL)).astype(np.int32)
    want = np.asarray(jmake(jm, jgen, importance_impl="pallas", paged=True, page_size=8)
                      .generate(params, jnp.asarray(prompt), jax.random.PRNGKey(0)))
    eng = tmake(tm, tgen, device="cpu", paged=True, page_size=8)
    got = eng.generate(torch.from_numpy(prompt)).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, tmake(tm, tgen, device="cpu").generate(
        torch.from_numpy(prompt)).numpy())
    assert eng.spill_pages(eng.init_engine_state(2, PL), [1, 2]) == ()


@pytest.mark.parametrize("kw", [dict(paged=True), dict(prefix_sharing=True),
                                dict(preemption=True)], ids=lambda k: next(iter(k)))
def test_ssm_serving_options_match_reference(kw):
    """Paged serving on a pure SSM stack, as the reference serves it: the
    staggered trace with early advance; sampled duplicate cohorts with
    prefix sharing (forks of pages that hold no plane, counted as the
    reference counts them); preemption on one slot and a one-request pool
    (the resumed request equals its run alone)."""
    jm, params, tm = models()
    temp = 0.8 if "prefix_sharing" in kw else 0.0
    jgen, tgen = _gen_configs(parallel_decoding=True, pd_threshold=0.5, temperature=temp,
                              **SERVE)
    n_vp = (PL + 16) // 8
    skw = dict(dict(max_slots=3, prompt_len=PL, paged=True, page_size=8, early_advance=True),
               **kw)
    if "preemption" in kw:
        skw.update(max_slots=1, kv_pages=n_vp + 1)
    rng = np.random.default_rng(12)
    if "prefix_sharing" in kw:
        a, b = (rng.integers(3, tm.cfg.vocab_size, n).astype(np.int32) for n in (16, 12))
        prompts, arrivals = [a, a, b, b], [0, 0, 0, 0]
        extra = [dict(sample_seed=100 + i) for i in range(4)]
    elif "preemption" in kw:
        prompts = [rng.integers(3, tm.cfg.vocab_size, PL).astype(np.int32) for _ in range(2)]
        arrivals, extra = [0, 3], [dict(priority=0), dict(priority=1)]
    else:
        prompts = [rng.integers(3, tm.cfg.vocab_size, n).astype(np.int32) for _, n, _ in TRACE]
        arrivals = [at for at, _, _ in TRACE]
        extra = [dict(max_new_tokens=m) for _, _, m in TRACE]
    outs, scheds = [], []
    for make_req, sched in ((JRequest, JScheduler(jm, params, jgen, **skw)),
                            (Request, StreamScheduler(tm, tgen, device="cpu", **skw))):
        reqs = [make_req(prompt=p.copy(), **e) for p, e in zip(prompts, extra)]
        step = 0
        while step <= max(arrivals) or sched.has_work():
            for at, r in zip(arrivals, reqs):
                if at == step:
                    sched.submit(r)
            sched.step()
            step += 1
        assert all(r.error is None and r.output is not None for r in reqs)
        outs.append([r.output for r in reqs])
        scheds.append(sched)
    for i, (x, y) in enumerate(zip(*outs)):
        np.testing.assert_array_equal(y, x, err_msg=f"request {i}")
    jsched, sched = scheds
    assert sched.allocator.free_pages == sched.allocator.num_pages - 1
    if "prefix_sharing" in kw:
        assert sched.stats.cow_forks > 0 and sched.stats.cow_forks == jsched.stats.cow_forks
    elif "preemption" in kw:
        assert sched.stats.preemptions >= 1 and sched.stats.preemptions == \
            jsched.stats.preemptions
        alone = tmake(tm, tgen, device="cpu").generate(torch.from_numpy(np.stack(prompts)))
        for i in range(2):
            np.testing.assert_array_equal(outs[1][i], alone.numpy()[i, PL:])
    else:
        assert sched.stats.early_advances > 0


def test_ssm_engine_options_outside_the_slice_raise():
    """What the reference refuses on an SSM stack the port refuses too: the
    adaptive cache, ``gather_refresh`` and sparse attention, in the engine
    and in the launcher."""
    _, _, tm = models()
    adaptive = _gen_configs(cache_prompt_interval=2, **SERVE)[1]
    with pytest.raises(ValueError, match="adaptive feature cache.*reference refuses"):
        StreamScheduler(tm, adaptive, device="cpu", prompt_len=PL)
    with pytest.raises(ValueError, match="gather_refresh.*reference refuses"):
        tmake(tm, _gen_configs(**SERVE)[1], device="cpu", paged=True, page_size=8,
              gather_refresh=True)
    for flags in (["--cache-prompt-interval", "2"], ["--paged", "--gather-refresh"]):
        with pytest.raises(ConfigError, match="reference refuses"):
            serve.main(["--device", "cpu", "--arch", "mamba2-370m", *flags])


def test_serve_launcher_mamba_on_the_cpu(capsys):
    done = serve.main(["--device", "cpu", "--arch", "mamba2-370m", "--requests", "3",
                       "--batch", "2", "--gen-length", "16", "--block-length", "8",
                       "--prompt-len", "16", "--early-advance", "--prompt-refresh-period", "4",
                       "--stream-print"])
    assert len(done) == 3 and all(r.error is None and r.output.shape == (16,) for r in done)
    out = capsys.readouterr().out
    assert "served 3 requests" in out and out.count("[stream]") == 6
