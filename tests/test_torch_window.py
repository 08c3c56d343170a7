"""The sliding active window in the port, on the CPU.

* ``core.schedule.window_limit``, ``ops.window_kv_clamp`` and
  ``ops.window_block_tables`` equal the reference's (``None`` is the
  identity);
* offline ``generate`` with ``window_blocks`` 1 and 2, long enough that the
  window cuts, gives the JAX engine's greedy tokens on reduced LLaDA and
  Dream (es, dualcache, es with the adaptive cache), dense and paged;
* the engine's ``window_override`` and ``anchor`` give the reference's
  tokens (es block-causal, dense and paged; vanilla);
* a window wider than the sequence gives the unwindowed tokens, and K/V
  past the horizon reach no attention output, dense or paged;
* windowed serving through ``StreamScheduler`` (dense and paged, early
  advance) gives the JAX scheduler's tokens;
* the launcher takes ``--window-blocks``, with ``--lazy-reserve`` too.

Lazy page reservation and window growth (the rest of the reference's
``test_suffix_window.py``) are held against the reference in
``test_torch_lazy_reserve.py``.

Reduced models (4 layers, weights x10) from ``test_torch_engine``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import make_engine as jmake
from repro.core.schedule import window_limit as jwindow_limit
from repro.kernels import ops as jops
from repro.runtime import Request as JRequest
from repro.runtime import StreamScheduler as JScheduler
from repro_torch.core import make_engine as tmake
from repro_torch.core import schedule as tschedule
from repro_torch.kernels import ops, ref
from repro_torch.launch import serve
from repro_torch.runtime import Request, StreamScheduler
from test_torch_engine import MODES, PROMPT_LEN, STAGES, gen_configs, models, prompt_for

PS = 8
GEN_LENGTH, BLOCK = 16, 4         # 4 blocks of 4: a window of 1 or 2 blocks cuts
RUN_MODES = {**MODES, "adaptive": dict(mode="es", skip_stages=STAGES, prompt_refresh_period=2,
                                       block_refresh_period=3, cache_prompt_interval=2)}

@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The reduced models' ops are tiny: one intra-op thread runs them as
    fast as eight alone, and keeps them fast when several test workers
    share the CPU (each op's parallel region would wait on busy cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _gens(mode="es", **kw):
    """Configs of 4 blocks of 4 (16 new tokens), a block refresh at the
    last step of a block."""
    jgen, tgen = gen_configs(**{"block_refresh_period": 3, **RUN_MODES[mode], **kw})
    return (dataclasses.replace(jgen, gen_length=GEN_LENGTH, block_length=BLOCK),
            dataclasses.replace(tgen, gen_length=GEN_LENGTH, block_length=BLOCK))


def test_window_helpers_match_reference():
    jgen, tgen = _gens(window_blocks=2)
    bs = np.array([16, 24, 40], np.int32)
    want = np.asarray(jwindow_limit(jgen, jnp.asarray(bs)))
    np.testing.assert_array_equal(tschedule.window_limit(tgen, bs), want)
    np.testing.assert_array_equal(tschedule.window_limit(tgen, torch.from_numpy(bs)).numpy(),
                                  want)
    assert tschedule.window_limit(_gens()[1], bs) is None
    rng = np.random.default_rng(0)
    kv_pos = np.where(rng.random((3, 48)) < 0.8, np.arange(48), -1).astype(np.int32)
    bt = rng.permutation(np.arange(1, 19))[:18].astype(np.int32).reshape(3, 6)
    bt[1, 2] = -1
    limit = np.array([20, 48, 7], np.int32)
    np.testing.assert_array_equal(
        ops.window_kv_clamp(torch.from_numpy(kv_pos), torch.from_numpy(limit)).numpy(),
        np.asarray(jops.window_kv_clamp(jnp.asarray(kv_pos), jnp.asarray(limit))))
    np.testing.assert_array_equal(
        ops.window_block_tables(torch.from_numpy(bt), torch.from_numpy(limit), PS).numpy(),
        np.asarray(jops.window_block_tables(jnp.asarray(bt), jnp.asarray(limit), PS)))
    t_kv, t_bt = torch.from_numpy(kv_pos), torch.from_numpy(bt)
    assert ops.window_kv_clamp(t_kv, None) is t_kv
    assert ops.window_block_tables(t_bt, None, PS) is t_bt


# each mode on both models, each model at both window widths
GENERATE_CASES = [("llada-8b", "es", 1), ("dream-7b", "es", 2), ("llada-8b", "dualcache", 2),
                  ("dream-7b", "dualcache", 1), ("llada-8b", "adaptive", 2),
                  ("dream-7b", "adaptive", 1)]


@pytest.mark.parametrize("arch,mode,window_blocks", GENERATE_CASES,
                         ids=[f"{a}-{m}-{w}" for a, m, w in GENERATE_CASES])
def test_generate_tokens_match_reference(arch, mode, window_blocks):
    jm, params, tm = models(arch)
    jgen, tgen = _gens(mode, window_blocks=window_blocks)
    # the first block's horizon lies inside the sequence: the window cuts
    assert tschedule.window_limit(tgen, PROMPT_LEN) < PROMPT_LEN + GEN_LENGTH
    prompt = prompt_for(tm.cfg, seed=2)
    want = np.asarray(jmake(jm, jgen, attn_impl="xla", importance_impl="xla")
                      .generate(params, jnp.asarray(prompt), jax.random.PRNGKey(0)))
    assert len(np.unique(want[:, PROMPT_LEN:])) >= 10, "degenerate reference output"
    for ekw in ({}, dict(paged=True, page_size=PS)):
        got = tmake(tm, tgen, device="cpu", **ekw).generate(torch.from_numpy(prompt))
        np.testing.assert_array_equal(got.numpy(), want, err_msg=str(ekw))


@pytest.mark.parametrize("mode", ["es", "vanilla"])
def test_window_override_and_anchor_match_reference(mode):
    """The engine's ``window_override`` (every layer's local window) and its
    ``anchor`` reach both attention kernels as the reference's do."""
    jm, params, tm = models("dream-7b")
    jgen, tgen = _gens(mode, block_causal=mode == "es")
    prompt = prompt_for(tm.cfg, seed=7)
    kw = dict(window_override=6, anchor=5)
    want = np.asarray(jmake(jm, jgen, attn_impl="xla", importance_impl="xla", **kw)
                      .generate(params, jnp.asarray(prompt), jax.random.PRNGKey(0)))
    plain = tmake(tm, tgen, device="cpu").generate(torch.from_numpy(prompt)).numpy()
    assert not np.array_equal(want, plain), "the window changed no token"
    for ekw in ({}, dict(paged=True, page_size=PS)) if mode == "es" else ({},):
        got = tmake(tm, tgen, device="cpu", **kw, **ekw).generate(torch.from_numpy(prompt))
        np.testing.assert_array_equal(got.numpy(), want, err_msg=str(ekw))


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_wide_window_equals_no_window(paged):
    _, _, tm = models("llada-8b")
    ekw = dict(paged=True, page_size=PS) if paged else {}
    prompt = torch.from_numpy(prompt_for(tm.cfg, seed=6))
    wide = tmake(tm, _gens(window_blocks=8)[1], device="cpu", **ekw).generate(prompt)
    assert tschedule.window_limit(_gens(window_blocks=8)[1], PROMPT_LEN) >= \
        PROMPT_LEN + GEN_LENGTH
    plain = tmake(tm, _gens()[1], device="cpu", **ekw).generate(prompt)
    np.testing.assert_array_equal(wide.numpy(), plain.numpy())


def test_far_suffix_reaches_no_output():
    """K/V at or past a row's horizon change no attention output: dense
    through the clamped kv_pos, paged through the clamp and the windowed
    read table."""
    rng = np.random.default_rng(3)
    b, n_vp, hkv = 2, 6, 2
    t_total = n_vp * PS
    limit = torch.tensor([20, 33], dtype=torch.int32)
    q = torch.from_numpy(rng.standard_normal((b, 4, 8, 32), np.float32))
    q_pos = torch.from_numpy(np.tile(np.arange(12, 20, dtype=np.int32), (b, 1)))
    kv_pos = ops.window_kv_clamp(torch.arange(t_total, dtype=torch.int32).repeat(b, 1), limit)
    k, v = (torch.from_numpy(rng.standard_normal((b, hkv, t_total, 32), np.float32))
            for _ in "kv")
    bt = torch.arange(1, b * n_vp + 1, dtype=torch.int32).view(b, n_vp)
    pools = [torch.zeros(b * n_vp + 1, PS, hkv, 32) for _ in "kv"]
    for pool, x in zip(pools, (k, v)):
        pool[1:] = x.transpose(1, 2).reshape(b * n_vp, PS, hkv, 32)
    read_bt = ops.window_block_tables(bt, limit, PS)
    dense = ref.attention_reference(q, k, v, q_pos, kv_pos)
    paged = ref.paged_attention_reference(q, *pools, q_pos, kv_pos, read_bt)
    for bi in range(b):
        lim = int(limit[bi])
        k[bi, :, lim:] += 100.0
        v[bi, :, lim:] -= 100.0
        for vp in range(n_vp):
            if vp * PS >= lim:
                for pool in pools:
                    pool[int(bt[bi, vp])] = 1e4      # a page the walk must not read
    np.testing.assert_array_equal(ref.attention_reference(q, k, v, q_pos, kv_pos).numpy(),
                                  dense.numpy())
    again = ref.paged_attention_reference(q, *pools, q_pos, kv_pos, read_bt)
    np.testing.assert_allclose(again.numpy(), dense.numpy(), atol=1e-5, rtol=0)
    np.testing.assert_allclose(paged.numpy(), dense.numpy(), atol=1e-5, rtol=0)


# (step at which it arrives, prompt length, max_new_tokens)
TRACE = [(0, 16, None), (0, 7, 8), (2, 12, None), (5, 16, 4)]


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_windowed_serving_matches_reference(paged):
    jm, params, tm = models("llada-8b")
    jgen, tgen = _gens(window_blocks=1, prompt_refresh_period=4, block_refresh_period=2)
    kw = dict(max_slots=2, prompt_len=PROMPT_LEN, paged=paged, page_size=PS,
              early_advance=True)
    rng = np.random.default_rng(8)
    prompts = [rng.integers(3, tm.cfg.vocab_size, n).astype(np.int32) for _, n, _ in TRACE]
    outs = []
    for sched, make_req in ((JScheduler(jm, params, jgen, attn_impl="xla", **kw), JRequest),
                            (StreamScheduler(tm, tgen, device="cpu", **kw), Request)):
        reqs = [make_req(prompt=p.copy(), max_new_tokens=m) for p, (_, _, m) in
                zip(prompts, TRACE)]
        step = 0
        while step <= TRACE[-1][0] or sched.has_work():
            for (at, _, _), r in zip(TRACE, reqs):
                if at == step:
                    sched.submit(r)
            sched.step()
            step += 1
        assert all(r.error is None and r.output is not None for r in reqs)
        outs.append([r.output for r in reqs])
    for want, got in zip(*outs):
        np.testing.assert_array_equal(got, want)
    assert len({len(np.unique(o)) for o in outs[1]}) > 1


def test_serve_launcher_takes_window_and_block_causal():
    for flags in (["--window-blocks", "2"], ["--block-causal"],
                  ["--paged", "--prefix-sharing", "--block-causal", "--window-blocks", "1"]):
        serve.validate(serve.parse_args(["--device", "cpu", *flags]))
    serve.validate(serve.parse_args(["--device", "cpu", "--paged", "--window-blocks", "1",
                                     "--lazy-reserve"]))
