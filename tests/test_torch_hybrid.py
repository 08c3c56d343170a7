"""The port's Jamba hybrid (jamba-v0.1-52b) against the JAX reference, on the CPU.

Reduced Jamba: 16 layers, two periods of 8 (attention at layers 3 and 11,
Mamba-2 SSD mixers on the other 14, the MoE FFN on the odd layers and a
dense MLP on the even ones), d_model 256, 4 query heads on 1 KV head of
32, 4 experts top-2 at capacity factor 0.5 (so picks drop), SSM state 16.
The reference's random-init parameter tree, as numpy arrays, is converted
for the port and the same inputs go through both:

* ``nocache`` logits within 1e-4 at the init scale;
* after a prefill and after a skip decode, each layer's K/V plane, SSM
  state, conv tail and ``ssmh`` within 1e-4 at the init scale;
* the mirrored ``ssmh`` fault on a hybrid layer: a prefill stores the block
  rows of ``h`` after the mixer's residual and before the FFN, in both
  packages (ROADMAP.md Queue C);
* offline tokens equal at x10 weights: greedy es, dualcache and vanilla,
  sampled es and int8 es.  The reference runs on XLA, its importance kernel
  in interpret mode;
* ``convert`` round-trips every leaf of a period-8 tree.
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
from repro.models.model import ForwardCtx as JCtx
from repro_torch import configs as tconfigs
from repro_torch.convert import params_from_numpy
from repro_torch.core import make_engine as tmake
from repro_torch.models import Model
from repro_torch.models.common import mlp_apply, rms_norm
from repro_torch.models.model import ForwardCtx as TCtx
from repro_torch.models.model import HybridCache, check_supported
from repro_torch.models.moe import moe_apply

ARCH = "jamba-v0.1-52b"
ATOL = 1e-4
PL = 16
BASE = dict(gen_length=16, block_length=8)
STAGES = tuple((s.layer, s.ratio) for s in tconfigs.default_skip_stages(16))


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the reduced model's ops are tiny, and several
    test workers share the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def reduced_cfg(c):
    """``c`` is either package's ``configs``: reduced Jamba (16 layers), MoE at
    capacity factor 0.5."""
    cfg = c.reduced(c.get_config(ARCH))
    return dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=0.5))


@functools.lru_cache(maxsize=None)
def models(scale=10.0):
    """(reference model, reference params, port model, numpy tree), weight
    matrices x ``scale``."""
    jcfg, tcfg = reduced_cfg(jconfigs), reduced_cfg(tconfigs)
    jm = jbuild(jcfg)
    tree = jax.tree_util.tree_map(lambda a: np.asarray(a) * (scale if a.ndim >= 2 else 1.0),
                                  jm.init(jax.random.PRNGKey(0)))
    tm = Model(tcfg, device="cpu")
    tm.load_state_dict(params_from_numpy(tree, tcfg, "cpu"))
    return jm, jax.tree_util.tree_map(jnp.asarray, tree), tm, tree


def gen_configs(**kw):
    stages = kw.pop("skip_stages", ())
    return tuple(c.GenerationConfig(skip_stages=tuple(c.SkipStage(*s) for s in stages),
                                    **BASE, **kw) for c in (jconfigs, tconfigs))


def _close(got, want, err_msg=""):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want), atol=ATOL,
                               rtol=0, err_msg=err_msg)


def test_structure_and_convert_round_trip():
    """The period-8 layout (kinds, FFNs, planes), and every leaf of the
    reference's tree lands bit-equal on layer ``g*8 + j`` of the port."""
    jm, _, tm, tree = models(1.0)
    cfg = tm.cfg
    check_supported(tconfigs.get_config(ARCH))
    assert (cfg.n_layers, tm.period, tm.n_groups) == (16, 8, 2)
    assert tm.attn_layers == [3, 11] and len(tm.ssm_layers) == 14
    assert [layer.moe for layer in tm.layers] == [l % 2 == 1 for l in range(16)]
    assert all(layer.ffn is not None for layer in tm.layers)
    sd = tm.state_dict()
    n = 0
    for j in range(8):
        for path, leaf in jax.tree_util.tree_flatten_with_path(tree["layers"][str(j)])[0]:
            name = ".".join(p.key for p in path)
            for g in range(2):
                got = sd[f"layers.{g * 8 + j}.{name}"]
                np.testing.assert_array_equal(got.numpy(), leaf[g], err_msg=name)
                n += 1
    assert n + 2 + (not cfg.tie_embeddings) == len(sd)
    np.testing.assert_array_equal(sd["embed"].numpy(), tree["embed"])
    assert tm.layers[3].ffn.router.dtype == torch.float32


def test_nocache_logits_match_reference():
    jm, params, tm, _ = models(1.0)
    toks = np.random.default_rng(2).integers(3, tm.cfg.vocab_size, (2, 32)).astype(np.int32)
    want, _ = jm.forward(params, jnp.asarray(toks))
    pos = torch.arange(32, dtype=torch.int32)[None].expand(2, 32).contiguous()
    got = tm.logits(tm.run_layers(tm.embed_tokens(torch.from_numpy(toks)), TCtx(positions=pos)))
    _close(got, want)


def _caches_close(tm, tcache: HybridCache, jcache: dict, what: str) -> None:
    for l in range(tm.cfg.n_layers):
        g, j = divmod(l, 8)
        if l in tm.kv_plane:
            i = tm.kv_plane[l]
            _close(tcache.kv.k[i], jcache["kv"][str(j)].k[g], f"{what}: layer {l} K")
            _close(tcache.kv.v[i], jcache["kv"][str(j)].v[g], f"{what}: layer {l} V")
        else:
            i = tm.ssm_plane[l]
            _close(tcache.ssm.state[i], jcache["ssm"][str(j)].state[g], f"{what}: {l} state")
            _close(tcache.ssm.conv_tail[i], jcache["ssm"][str(j)].conv_tail[g],
                   f"{what}: layer {l} conv tail")
            _close(tcache.ssm.ssmh[i], jcache["ssmh"][str(j)][g], f"{what}: layer {l} ssmh")


@functools.lru_cache(maxsize=None)
def _prefilled():
    """Both packages' caches after a prefill at per-row block starts 16 and
    24, run group by group; the port's hidden state after each group is
    held to the reference's on the way."""
    jm, params, tm, _ = models(1.0)
    b, t, lb = 2, 32, 8
    rng = np.random.default_rng(3)
    tokens = rng.integers(0, tm.cfg.vocab_size, (b, t)).astype(np.int32)
    bs = np.array([16, 24], np.int32)
    pos = np.tile(np.arange(t, dtype=np.int32), (b, 1))
    jcache = jm.init_cache(b, t, lb)
    tcache = tm.init_cache(b, t, block_len=lb)
    jctx = JCtx(positions=jnp.asarray(pos), mode="prefill", kv_pos=jnp.asarray(pos),
                slot_idx=jnp.asarray(pos), block_start=jnp.asarray(bs))
    jh = jm.embed(params, jnp.asarray(tokens))
    th = tm.embed_tokens(torch.from_numpy(tokens))
    for g in range(2):
        out = jm.run_layers(params, jh, jctx, jcache, group_lo=g, group_hi=g + 1)
        jh, jcache = out.h, out.caches
        th = tm.run_layers(th, _prefill_ctx(pos, bs), tcache, group_lo=g, group_hi=g + 1)
        _close(th, jh, f"prefill group {g}")
    return tcache, jcache, tokens, bs, pos


def _prefill_ctx(pos, bs):
    return TCtx(torch.from_numpy(pos), "prefill", kv_pos=torch.from_numpy(pos),
                slot_idx=torch.from_numpy(pos), block_start=torch.from_numpy(bs))


def test_prefill_and_skip_decode_caches_match_reference():
    """Every layer's caches after the prefill, then after a decode of 5
    scrambled block rows through group 0 and 2 of them through group 1 (the
    es shrink at the group-1 boundary), within 1e-4; a decode leaves every
    SSM state at the block start."""
    jm, params, tm, _ = models(1.0)
    tcache, jcache, tokens, bs, pos = _prefilled()
    tcache = HybridCache(*(type(p)(*(t.clone() for t in p)) for p in tcache))
    _caches_close(tm, tcache, jcache, "prefill")
    b, lb = 2, 8
    rng = np.random.default_rng(4)
    s_idx = np.stack([rng.permutation(lb)[:5] for _ in range(b)]).astype(np.int32)
    keep = np.array([[3, 0], [1, 4]])
    state_before = tcache.ssm.state.clone()
    jh = jm.embed(params, jnp.asarray(np.take_along_axis(tokens, bs[:, None] + s_idx, 1))) * 1.5
    th = tm.embed_tokens(torch.from_numpy(np.take_along_axis(tokens, bs[:, None] + s_idx, 1))) \
        * 1.5
    for g, sel in ((0, None), (1, keep)):
        if sel is not None:
            s_idx = np.take_along_axis(s_idx, sel, 1)
            jh = jnp.take_along_axis(jh, jnp.asarray(sel)[..., None], axis=1)
            th = torch.gather(th, 1, torch.from_numpy(sel)[..., None].expand(-1, -1, th.shape[-1]))
        rows = bs[:, None] + s_idx
        jctx = JCtx(positions=jnp.asarray(rows), mode="decode", kv_pos=jnp.asarray(pos),
                    slot_idx=jnp.asarray(rows), block_idx=jnp.asarray(s_idx))
        tctx = TCtx(torch.from_numpy(rows), "decode", kv_pos=torch.from_numpy(pos),
                    slot_idx=torch.from_numpy(rows), block_idx=torch.from_numpy(s_idx))
        out = jm.run_layers(params, jh, jctx, jcache, group_lo=g, group_hi=g + 1)
        jh, jcache = out.h, out.caches
        th = tm.run_layers(th, tctx, tcache, group_lo=g, group_hi=g + 1)
        _close(th, jh, f"decode group {g}")
    _caches_close(tm, tcache, jcache, "decode")
    assert torch.equal(tcache.ssm.state, state_before)


def test_ssmh_holds_the_mixer_residual_before_the_ffn(monkeypatch):
    """The mirrored reference fault (ROADMAP.md Queue C) on hybrid layers: a
    prefill stores in ``ssmh`` the block rows of ``h`` after the mixer's
    residual and before the layer's FFN -- neither the layer's input, which
    a decode scatters into the buffer, nor its output.  The port's buffer
    equals those rows exactly, and the reference's equals them within
    1e-4."""
    _, _, tm, _ = models(1.0)
    _, jcache, tokens, bs, pos = _prefilled()
    seen = {}
    apply_ssm = tm._apply_ssm

    def spy(layer, i, h, ctx, cache):
        out = apply_ssm(layer, i, h, ctx, cache)
        seen[i] = (layer, h, out)
        return out
    monkeypatch.setattr(tm, "_apply_ssm", spy)
    tcache = tm.init_cache(2, 32, block_len=8)
    tm.run_layers(tm.embed_tokens(torch.from_numpy(tokens)), _prefill_ctx(pos, bs), tcache)
    cols = torch.from_numpy(bs)[:, None] + torch.arange(8)

    def blk(t):
        return torch.gather(t, 1, cols[..., None].expand(-1, -1, t.shape[-1]))
    assert len(seen) == 14
    for l in tm.ssm_layers:
        g, j = divmod(l, 8)
        i = tm.ssm_plane[l]
        layer, h_in, mid = seen[i]
        hn = rms_norm(mid, layer.ln2, tm.cfg.rms_eps)
        h_out = mid + (moe_apply(layer.ffn, tm.cfg, hn) if layer.moe
                       else mlp_apply(layer.ffn, hn, tm.cfg.act))
        assert torch.equal(tcache.ssm.ssmh[i], blk(mid)), f"layer {l}"
        _close(blk(mid), jcache["ssmh"][str(j)][g], f"reference, layer {l}")
        assert (blk(mid) - blk(h_in)).abs().max() > 1e-2, f"layer {l}: not its input"
        assert (blk(mid) - blk(h_out)).abs().max() > 1e-3, f"layer {l}: not its output"


RUNS = {
    "es": dict(mode="es", skip_stages=STAGES),
    "dualcache": dict(mode="dualcache"),
    "vanilla": dict(mode="vanilla"),
    "es_sampled": dict(mode="es", skip_stages=STAGES, temperature=0.8),
    "es_int8": dict(mode="es", skip_stages=STAGES),
}


@pytest.mark.parametrize("run", list(RUNS))
def test_generate_tokens_identical(run):
    """Offline generation at x10 weights: the port's tokens equal the JAX
    engine's.  The es runs take ``default_skip_stages(16)`` (layers 2 and
    4), which round to group boundary 1 and compound to ratio 0.75: 2 of
    the block's 8 rows go on through group 1."""
    jm, params, tm, _ = models()
    jgen, tgen = gen_configs(**RUNS[run])
    kw = dict(kv_cache_dtype="int8") if run == "es_int8" else {}
    prompt = np.random.default_rng(1).integers(3, tm.cfg.vocab_size, (2, PL)).astype(np.int32)
    want = np.asarray(jmake(jm, jgen, importance_impl="pallas", **kw)
                      .generate(params, jnp.asarray(prompt), jax.random.PRNGKey(0)))
    assert len(np.unique(want[:, PL:])) >= 10, "degenerate reference output"
    engine = tmake(tm, tgen, device="cpu", **kw)
    got = engine.generate(torch.from_numpy(prompt))
    np.testing.assert_array_equal(got.numpy(), want)
    if tgen.mode == "es":
        assert [(s.group_lo, s.group_hi, s.keep_k) for s in engine.segments] == [
            (0, 1, 2), (1, 2, None)]
        assert engine.pass_counts["skip"] > 0
    if kw:
        assert engine.last_state.cache.kv.quantized
