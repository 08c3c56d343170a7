"""The port's Mamba-2 model path (mamba2-370m) against the JAX reference, on the CPU.

Reduced mamba2-370m with 4 layers (d_model 256, 32 heads of 16, d_state 16,
chunk 16, tied embeddings): the reference's random-init parameters, as numpy
arrays, are converted for the port, and the same inputs go through both.
Floats are compared at the init scale within 1e-4 abs (summation order, as
in ``test_torch_model``); tokens with every weight matrix x10, the
convention of ``test_torch_engine`` (greedy and sampled tokens identical).
The reference runs its SSD through XLA (``mamba_apply`` calls ``ops.ssd``
without ``impl=``) and its importance kernel in interpret mode.
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
from repro.models.mamba import SSMState as JState
from repro.models.mamba import mamba_apply as jmamba_apply
from repro.models.model import ForwardCtx as JCtx
from repro_torch import configs as tconfigs
from repro_torch.convert import params_from_numpy
from repro_torch.core import make_engine as tmake
from repro_torch.models import Model
from repro_torch.models.mamba import SSMCache, SSMState, mamba_apply
from repro_torch.models.model import ForwardCtx as TCtx

ARCH = "mamba2-370m"
ATOL = 1e-4
STAGES = ((1, 0.5), (2, 0.5))


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
def models(scale=10.0, param_dtype="float32"):
    """(reference model, reference params, port model) from one parameter
    tree, weight matrices x ``scale``."""
    jcfg = dataclasses.replace(jconfigs.reduced(jconfigs.get_config(ARCH)), n_layers=4)
    tcfg = dataclasses.replace(tconfigs.reduced(tconfigs.get_config(ARCH)), n_layers=4,
                               param_dtype=param_dtype)
    jm = jbuild(jcfg)
    tree = jax.tree_util.tree_map(lambda a: np.asarray(a) * (scale if a.ndim >= 2 else 1.0),
                                  jm.init(jax.random.PRNGKey(0)))
    tm = Model(tcfg, device="cpu")
    tm.load_state_dict(params_from_numpy(tree, tcfg, "cpu"))
    return jm, jax.tree_util.tree_map(jnp.asarray, tree), tm


def _close(got, want, atol=ATOL, err_msg=""):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want), atol=atol,
                               rtol=0, err_msg=err_msg)


def _caches_close(tc: SSMCache, jc: dict, what: str) -> None:
    _close(tc.state, jc["ssm"]["0"].state, err_msg=f"{what}: state")
    _close(tc.conv_tail, jc["ssm"]["0"].conv_tail, err_msg=f"{what}: conv_tail")
    _close(tc.ssmh, jc["ssmh"]["0"], err_msg=f"{what}: ssmh")


def test_config_registry_and_converter_layout():
    """The registered config equals the reference's; the tied head has no
    ``lm_head``; the mixer's per-head leaves stay f32 in a bf16 model."""
    full = tconfigs.get_config(ARCH)
    assert dataclasses.asdict(full) == dataclasses.asdict(jconfigs.get_config(ARCH))
    jm, params, tm = models(1.0)
    sd = tm.state_dict()
    assert "lm_head" not in sd and "lm_head" not in params
    assert set(sd) == {"embed", "final_norm"} | {
        f"layers.{g}.{k}" for g in range(4)
        for k in ["ln1"] + [f"mixer.{m}" for m in params["layers"]["0"]["mixer"]]}
    np.testing.assert_array_equal(sd["layers.2.mixer.x_proj"].numpy(),
                                  np.asarray(params["layers"]["0"]["mixer"]["x_proj"][2]))
    _, _, bf = models(1.0, "bfloat16")
    assert bf.layers[0].mixer.a_log.dtype == torch.float32
    assert bf.layers[0].mixer.x_proj.dtype == torch.bfloat16


@pytest.mark.parametrize("resume", [False, True], ids=["from_start", "from_state"])
def test_mixer_with_capture_matches_reference(resume):
    """One mixer over a 24-row span (chunk 16, so the scan pads), with the
    state captured at per-row positions 5 and 17: the output, the final
    state and conv tail, and the captured ones."""
    jm, params, tm = models(1.0)
    cfg = tm.cfg
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 24, cfg.d_model)).astype(np.float32)
    cap = np.array([5, 17], np.int32)
    jp = jax.tree_util.tree_map(lambda a: a[1], params["layers"]["0"]["mixer"])
    jstate = tstate = None
    if resume:
        st = rng.standard_normal((2, 32, 16, 16)).astype(np.float32)
        tail = rng.standard_normal((2, 3, 512 + 32)).astype(np.float32)
        jstate, tstate = (JState(jnp.asarray(st), jnp.asarray(tail)),
                          SSMState(torch.from_numpy(st), torch.from_numpy(tail)))
    jy, jfin, jcap = jmamba_apply(jp, jm.cfg, jnp.asarray(x), state=jstate,
                                  capture_pos=jnp.asarray(cap))
    ty, tfin, tcap = mamba_apply(tm.layers[1].mixer, cfg, torch.from_numpy(x), state=tstate,
                                 capture_pos=torch.from_numpy(cap))
    _close(ty, jy, err_msg="y")
    for name, t, j in (("final", tfin, jfin), ("captured", tcap, jcap)):
        _close(t.state, j.state, err_msg=f"{name} state")
        _close(t.conv_tail, j.conv_tail, err_msg=f"{name} conv tail")


def test_stack_prefill_and_decode_caches_match_reference():
    """Layer by layer, as the ES engine runs segments: the hidden state
    after each layer and all three SSM caches after a prefill (per-row block
    starts 16 and 24) and after a decode of 5 scrambled rows of each row's
    block.  After the prefill ``ssmh[g]`` holds layer g's *output* block rows
    in both packages -- the reference's behaviour, mirrored (ROADMAP.md Queue
    C) -- while the decode scatters the layer's *input* rows into it."""
    jm, params, tm = models(1.0)
    b, t, lb = 2, 32, 8
    rng = np.random.default_rng(2)
    tokens = rng.integers(0, tm.cfg.vocab_size, (b, t)).astype(np.int32)
    bs = np.array([16, 24], np.int32)
    pos = np.tile(np.arange(t, dtype=np.int32), (b, 1))
    jcache = jm.init_cache(b, t, lb)
    tcache = tm.init_cache(b, t, block_len=lb)
    assert isinstance(tcache, SSMCache)
    assert tuple(tcache.ssmh.shape) == jcache["ssmh"]["0"].shape == (4, b, lb, 256)
    jctx = JCtx(positions=jnp.asarray(pos), mode="prefill", kv_pos=jnp.asarray(pos),
                slot_idx=jnp.asarray(pos), block_start=jnp.asarray(bs))
    tctx = TCtx(torch.from_numpy(pos), "prefill", block_start=torch.from_numpy(bs))
    jh = jm.embed(params, jnp.asarray(tokens))
    th = tm.embed_tokens(torch.from_numpy(tokens))
    cols = torch.from_numpy(bs)[:, None] + torch.arange(lb)
    for g in range(4):
        layer_in = th
        out = jm.run_layers(params, jh, jctx, jcache, group_lo=g, group_hi=g + 1)
        jh, jcache = out.h, out.caches
        th = tm.run_layers(th, tctx, tcache, group_lo=g, group_hi=g + 1)
        _close(th, jh, err_msg=f"prefill layer {g}")
        blk_out = torch.gather(th, 1, cols[..., None].expand(-1, -1, th.shape[-1]))
        blk_in = torch.gather(layer_in, 1, cols[..., None].expand(-1, -1, th.shape[-1]))
        assert torch.equal(tcache.ssmh[g], blk_out)                  # the layer's output
        np.testing.assert_array_equal(np.asarray(jcache["ssmh"]["0"][g]),
                                      np.asarray(jh)[np.arange(b)[:, None], cols.numpy()])
        _close(tcache.ssmh[g], np.asarray(jcache["ssmh"]["0"][g]))
        assert (tcache.ssmh[g] - blk_in).abs().max() > 0.1           # not its input
    _caches_close(tcache, jcache, "prefill")

    s_idx = np.stack([rng.permutation(lb)[:5] for _ in range(b)]).astype(np.int32)
    rows = bs[:, None] + s_idx
    blk_tok = np.take_along_axis(tokens, rows, axis=1)
    jctx = JCtx(positions=jnp.asarray(rows), mode="decode", kv_pos=jnp.asarray(pos),
                slot_idx=jnp.asarray(rows), block_idx=jnp.asarray(s_idx))
    tctx = TCtx(torch.from_numpy(rows), "decode", block_idx=torch.from_numpy(s_idx))
    jh = jm.embed(params, jnp.asarray(blk_tok)) * 1.5          # fresh rows differ from the cache
    th = tm.embed_tokens(torch.from_numpy(blk_tok)) * 1.5
    state_before = tcache.state.clone()
    for lo, hi in ((0, 1), (1, 3), (3, 4)):
        out = jm.run_layers(params, jh, jctx, jcache, group_lo=lo, group_hi=hi)
        jh, jcache = out.h, out.caches
        th = tm.run_layers(th, tctx, tcache, group_lo=lo, group_hi=hi)
        _close(th, jh, err_msg=f"decode layers [{lo}, {hi})")
    _caches_close(tcache, jcache, "decode")
    assert torch.equal(tcache.state, state_before)           # the state stays at block start


def test_nocache_stack_and_tied_head_match_reference():
    jm, params, tm = models(1.0)
    tokens = np.random.default_rng(1).integers(0, tm.cfg.vocab_size + 1, (2, 24)).astype(np.int32)
    tokens[:, -8:] = tm.cfg.vocab_size                        # [mask] ids embed too
    pos = np.tile(np.arange(24, dtype=np.int32), (2, 1))
    jh = jm.run_layers(params, jm.embed(params, jnp.asarray(tokens)),
                       JCtx(positions=jnp.asarray(pos))).h
    th = tm.run_layers(tm.embed_tokens(torch.from_numpy(tokens)), TCtx(torch.from_numpy(pos)))
    _close(th, jh)
    _close(tm.logits(th), jm.logits(params, jh))


def _gen_configs(**kw):
    stages = kw.pop("skip_stages", ())
    base = dict(gen_length=16, block_length=8)
    return (jconfigs.GenerationConfig(
                skip_stages=tuple(jconfigs.SkipStage(*s) for s in stages), **base, **kw),
            tconfigs.GenerationConfig(
                skip_stages=tuple(tconfigs.SkipStage(*s) for s in stages), **base, **kw))


RUNS = {
    "vanilla": dict(mode="vanilla"),
    "dualcache": dict(mode="dualcache"),
    "es": dict(mode="es", skip_stages=STAGES),
    "es_sampled": dict(mode="es", skip_stages=STAGES, temperature=0.8),
    "es_sampled_top_p": dict(mode="es", skip_stages=STAGES, temperature=0.7, top_p=0.9),
}


@pytest.mark.parametrize("run", list(RUNS))
def test_generate_tokens_identical(run):
    """Offline generation, greedy in the three modes and sampled es: the
    port's tokens equal the JAX engine's.  The es segments shrink the block
    8 -> 4 -> 2 rows."""
    jm, params, tm = models()
    jgen, tgen = _gen_configs(**RUNS[run])
    prompt = np.random.default_rng(1).integers(3, tm.cfg.vocab_size, (2, 16)).astype(np.int32)
    want = np.asarray(jmake(jm, jgen, importance_impl="pallas")
                      .generate(params, jnp.asarray(prompt), jax.random.PRNGKey(0)))
    assert len(np.unique(want[:, 16:])) >= 10, "degenerate reference output"
    engine = tmake(tm, tgen, device="cpu")
    got = engine.generate(torch.from_numpy(prompt))
    np.testing.assert_array_equal(got.numpy(), want)
    if tgen.mode == "es":
        assert [s.keep_k for s in engine.segments] == [4, 2, None]
        assert engine.pass_counts["skip"] > 0
