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
* the options outside this slice raise, naming ROADMAP.md.
"""
import jax
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


@pytest.mark.parametrize("kw", [dict(paged=True), dict(prefix_sharing=True),
                                dict(preemption=True)], ids=lambda k: next(iter(k)))
def test_ssm_serving_options_outside_the_slice_raise(kw):
    _, _, tm = models()
    with pytest.raises(ConfigError, match="SSM stack.*ROADMAP"):
        StreamScheduler(tm, _gen_configs(**SERVE)[1], device="cpu", prompt_len=PL, **kw)


def test_ssm_engine_options_outside_the_slice_raise():
    _, _, tm = models()
    adaptive = _gen_configs(cache_prompt_interval=2, **SERVE)[1]
    with pytest.raises(NotImplementedError, match="adaptive feature cache.*ROADMAP"):
        StreamScheduler(tm, adaptive, device="cpu", prompt_len=PL)
    with pytest.raises(NotImplementedError, match="paged KV.*ROADMAP"):
        tmake(tm, _gen_configs(**SERVE)[1], device="cpu", paged=True, page_size=8)
    for flags in (["--paged"], ["--cache-prompt-interval", "2"]):
        with pytest.raises(ConfigError, match="SSM stack.*ROADMAP"):
            serve.main(["--device", "cpu", "--arch", "mamba2-370m", *flags])


def test_serve_launcher_mamba_on_the_cpu(capsys):
    done = serve.main(["--device", "cpu", "--arch", "mamba2-370m", "--requests", "3",
                       "--batch", "2", "--gen-length", "16", "--block-length", "8",
                       "--prompt-len", "16", "--early-advance", "--prompt-refresh-period", "4",
                       "--stream-print"])
    assert len(done) == 3 and all(r.error is None and r.output.shape == (16,) for r in done)
    out = capsys.readouterr().out
    assert "served 3 requests" in out and out.count("[stream]") == 6
