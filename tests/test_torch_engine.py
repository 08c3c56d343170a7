"""The port's diffusion engine against the JAX reference's, on the CPU.

Reduced LLaDA-8B and Dream-7B (4 layers) with the reference's random-init
parameters.  For token parity every weight matrix (ndim >= 2) is scaled by
10 in the shared numpy tree: at the init scale the models emit one repeated
id per block and token equality would check almost nothing.  The reference
runs with its Pallas kernels in interpret mode (and, for ES, also with its
XLA lowering).  Greedy tokens must be identical; single steps must agree to
1e-4, at the init scale: x10 weights grow the hidden states past 1e3, where
one float32 ulp is already above 1e-4.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.core import make_engine as jmake
from repro.models import build_model as jbuild
from repro_torch import configs as tconfigs
from repro_torch.convert import params_from_numpy
from repro_torch.core import make_engine as tmake
from repro_torch.models import Model

ARCHS = ["llada-8b", "dream-7b"]
BASE = dict(gen_length=16, block_length=8)
STAGES = ((1, 0.5), (2, 0.5))
MODES = {
    "vanilla": dict(mode="vanilla"),
    "dualcache": dict(mode="dualcache"),
    "es": dict(mode="es", skip_stages=STAGES),
    "es_parallel": dict(mode="es", skip_stages=STAGES, parallel_decoding=True),
}
# (mode, reference impl for attention and importance)
RUNS = [("vanilla", "pallas"), ("dualcache", "pallas"), ("es", "pallas"), ("es", "xla"),
        ("es_parallel", "pallas")]
PROMPT_LEN = 16


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The reduced models' ops are tiny: one intra-op thread runs them as
    fast as eight alone, and keeps them fast when several test workers
    share the CPU (each op's parallel region would wait on busy cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def models(arch, scale=10.0):
    """(reference model, reference params, port model), weight matrices x ``scale``."""
    jcfg = dataclasses.replace(jconfigs.reduced(jconfigs.get_config(arch)), n_layers=4)
    tcfg = dataclasses.replace(tconfigs.reduced(tconfigs.get_config(arch)), n_layers=4)
    jm = jbuild(jcfg)
    tree = jax.tree_util.tree_map(lambda a: np.asarray(a) * (scale if a.ndim >= 2 else 1.0),
                                  jm.init(jax.random.PRNGKey(0)))
    tm = Model(tcfg, device="cpu")
    tm.load_state_dict(params_from_numpy(tree, tcfg, "cpu"))
    return jm, jax.tree_util.tree_map(jnp.asarray, tree), tm


def gen_configs(**kw):
    stages = kw.pop("skip_stages", ())
    j = jconfigs.GenerationConfig(
        skip_stages=tuple(jconfigs.SkipStage(*s) for s in stages), **BASE, **kw)
    t = tconfigs.GenerationConfig(
        skip_stages=tuple(tconfigs.SkipStage(*s) for s in stages), **BASE, **kw)
    return j, t


def prompt_for(cfg, seed=1):
    return np.random.default_rng(seed).integers(3, cfg.vocab_size, (2, PROMPT_LEN)).astype(np.int32)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mode,impl", RUNS, ids=[f"{m}-{i}" for m, i in RUNS])
def test_generate_tokens_identical(arch, mode, impl):
    jm, params, tm = models(arch)
    jgen, tgen = gen_configs(**MODES[mode])
    prompt = prompt_for(tm.cfg)
    want = np.asarray(jmake(jm, jgen, attn_impl=impl, importance_impl=impl)
                      .generate(params, jnp.asarray(prompt), jax.random.PRNGKey(0)))
    assert len(np.unique(want[:, PROMPT_LEN:])) >= 10, "degenerate reference output"
    engine = tmake(tm, tgen, device="cpu")
    got = engine.generate(torch.from_numpy(prompt))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert engine.iterations >= BASE["gen_length"] // BASE["block_length"]
    assert not (got[:, PROMPT_LEN:] == tm.cfg.vocab_size).any()


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_then_decode_steps_match(arch):
    """Prefill then three ES decode iterations: conf, hidden indicator caches
    and K/V caches within 1e-4, predictions and tokens exact."""
    jm, params, tm = models(arch, scale=1.0)
    jgen, tgen = gen_configs(**MODES["es"])
    prompt = prompt_for(tm.cfg, seed=3)
    tokens = np.concatenate(
        [prompt, np.full((2, BASE["gen_length"]), tm.cfg.vocab_size, np.int32)], axis=1)
    jeng = jmake(jm, jgen, attn_impl="pallas", importance_impl="pallas", disallow_eos=True)
    teng = tmake(tm, tgen, device="cpu", disallow_eos=True)
    jprefill, jdecode = jax.jit(jeng.prefill), jax.jit(jeng.decode_iteration)
    jst = jeng.make_block_state(jnp.asarray(tokens), jax.random.PRNGKey(0))
    tst = teng.make_block_state(torch.from_numpy(tokens))
    bs = PROMPT_LEN
    for step in range(4):
        if step == 0:
            jst, tst = jprefill(params, jst, bs), teng.prefill(tst, bs)
        else:
            jst, tst = jdecode(params, jst, bs), teng.decode_iteration(tst, bs)
        np.testing.assert_array_equal(tst.pred.numpy(), np.asarray(jst.pred))
        np.testing.assert_array_equal(tst.tokens.numpy(), np.asarray(jst.tokens))
        np.testing.assert_allclose(tst.conf.numpy(), np.asarray(jst.conf), atol=1e-4, rtol=0)
        assert len(tst.hidden) == len(jst.hidden) == 2
        for th, jh in zip(tst.hidden, jst.hidden):
            np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=1e-4, rtol=0)
        for tc, jc in ((tst.cache.k, jst.caches["kv"]["0"].k), (tst.cache.v, jst.caches["kv"]["0"].v)):
            np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-4, rtol=0)
        assert tst.t == int(jst.t)


def test_segments_and_active_sizes_match_reference():
    from repro.core.schedule import resolve_segments as jresolve
    from repro_torch.core.schedule import resolve_segments as tresolve

    for arch, n in (("llada-8b", 32), ("dream-7b", 28)):
        jcfg = jconfigs.get_config(arch)
        tcfg = tconfigs.get_config(arch)
        jgen = jconfigs.GenerationConfig(skip_stages=jconfigs.default_skip_stages(n),
                                         block_length=32)
        tgen = tconfigs.GenerationConfig(skip_stages=tconfigs.default_skip_stages(n),
                                         block_length=32)
        jseg, jsizes = jresolve(jcfg, jgen, 32)
        tseg, tsizes = tresolve(tcfg, tgen, 32)
        assert [dataclasses.astuple(s) for s in jseg] == [dataclasses.astuple(s) for s in tseg]
        assert jsizes == tsizes


def test_cadence_matches_reference():
    from repro.core.schedule import branch_index as jbranch
    from repro_torch.core.schedule import branch_index as tbranch

    for pp, bp in ((32, 4), (0, 4), (8, 0), (5, 3)):
        jgen = jconfigs.GenerationConfig(prompt_refresh_period=pp, block_refresh_period=bp)
        tgen = tconfigs.GenerationConfig(prompt_refresh_period=pp, block_refresh_period=bp)
        ts = np.arange(40, dtype=np.int32)
        want = np.asarray(jbranch(jgen, jnp.asarray(ts)))
        assert [tbranch(tgen, int(t)) for t in ts] == want.tolist()


@pytest.mark.parametrize("change,error", [
    (dict(sparse_attention=True), ValueError), (dict(mode="beam"), NotImplementedError),
], ids=["sparse_attention", "mode"])
def test_features_outside_the_slice_raise(change, error):
    """An unknown mode is outside the port; sparse attention is in it, but,
    as in the reference, needs a skip stage as its probe (none here)."""
    _, _, tm = models("llada-8b")
    gen = tconfigs.GenerationConfig(**{**BASE, **change})
    with pytest.raises(error):
        tmake(tm, gen, device="cpu")


@pytest.mark.parametrize("arch,kw,match", [
    ("llada-8b", dict(kv_cache_dtype="fp8"), "kv_cache_dtype"),
    ("llada-8b", dict(gather_refresh=True), "paged KV pool"),
    ("mamba2-370m", dict(gather_refresh=True, paged=True), "attention-only"),
], ids=["int8_kv", "gather_refresh", "gather_refresh_ssm"])
def test_engine_options_outside_the_slice_raise(arch, kw, match):
    """The engine options the reference refuses, as ``ValueError``: a KV
    cache dtype other than None or "int8", and ``gather_refresh`` without
    the paged pool or on a stack that is not attention-only."""
    if arch == "llada-8b":
        tm = models(arch)[2]
    else:
        tcfg = dataclasses.replace(tconfigs.reduced(tconfigs.get_config(arch)), n_layers=2)
        tm = Model(tcfg, device="cpu")
    with pytest.raises(ValueError, match=match):
        tmake(tm, tconfigs.GenerationConfig(**BASE), device="cpu", **kw)
