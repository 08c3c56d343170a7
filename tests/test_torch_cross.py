"""The port's encoder-conditioned archs against the JAX reference, on the CPU:
Llama-3.2-Vision (a cross-attention layer at position 3 of each period of
5) and SeamlessM4T (an encoder stack, then cross-attention on every decoder
layer and no self-attention).

Reduced configs at f32: the vision model at 10 layers (cross layers 3 and
8), d_model 256 with patch embeddings of width 128, so it has ``enc_proj``;
SeamlessM4T at 2 decoder and 2 encoder layers, ``d_enc`` 128; 16 encoder
tokens each.  The reference's random-init tree, as numpy arrays, is
converted for the port and the same inputs go through both:

* ``convert`` maps every reference leaf once, bit-equal, and keeps
  ``gate_attn`` float32 under bfloat16 parameters;
* ``Model.encode`` within 1e-5, ``nocache`` logits within 1e-4, at the init
  scale;
* one layer-by-layer prefill and skip decode: the hidden state after each
  group, the cross planes (projected and stored by the prefill, its owned
  row only, read unchanged by the decode) and the vision model's K/V
  planes, within 1e-4;
* offline tokens equal at x10 weights in vanilla, dualcache and es, es
  sampled, and es with the int8 K/V cache on the vision model.  The
  reference runs its importance kernel in interpret mode.  SeamlessM4T's
  decoder has no self-attention, so every [mask] row of a block computes
  the same confidence: greedy, a block unmasks in its prefill, and its
  sampled runs drive the decode passes;
* the port refuses the adaptive cache, ``gather_refresh`` and sparse
  attention on both, where the reference refuses them or fails.
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
from repro_torch.models.model import EncDecCache
from repro_torch.models.model import ForwardCtx as TCtx

VLM, AUDIO = "llama-3.2-vision-11b", "seamless-m4t-large-v2"
ARCHS = [VLM, AUDIO]
PL = 16
BASE = dict(gen_length=16, block_length=8)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the reduced models' ops are tiny, and several
    test workers share the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def models(arch, scale=10.0):
    """(reference model, reference params, port model, numpy tree), weight
    matrices x ``scale``."""
    jcfg, tcfg = jconfigs.reduced(jconfigs.get_config(arch)), \
        tconfigs.reduced(tconfigs.get_config(arch))
    jm = jbuild(jcfg)
    tree = jax.tree_util.tree_map(lambda a: np.asarray(a) * (scale if a.ndim >= 2 else 1.0),
                                  jm.init(jax.random.PRNGKey(0)))
    tm = Model(tcfg, device="cpu")
    tm.load_state_dict(params_from_numpy(tree, tcfg, "cpu"))
    return jm, jax.tree_util.tree_map(jnp.asarray, tree), tm, tree


def inputs(cfg, b=2, seed=1):
    """(prompt [b, PL] int32, enc_embeds [b, E, d_enc] float32)."""
    rng = np.random.default_rng(seed)
    return (rng.integers(3, cfg.vocab_size, (b, PL)).astype(np.int32),
            rng.normal(size=(b, cfg.n_enc_tokens, cfg.d_enc)).astype(np.float32))


def stages(cfg):
    return tuple((s.layer, s.ratio) for s in tconfigs.default_skip_stages(cfg.n_layers))


def gen_configs(**kw):
    st = kw.pop("skip_stages", ())
    return tuple(c.GenerationConfig(skip_stages=tuple(c.SkipStage(*s) for s in st),
                                    **BASE, **kw) for c in (jconfigs, tconfigs))


def _close(got, want, atol=1e-4, err_msg=""):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want), atol=atol,
                               rtol=0, err_msg=err_msg)


@pytest.mark.parametrize("arch", ARCHS)
def test_convert_maps_every_leaf_once(arch):
    """Every leaf of the reference's tree (stacked layers, the encoder stack,
    ``enc_proj``) lands bit-equal on exactly one port parameter, and the
    port has no other; under bf16 parameters ``gate_attn`` stays f32."""
    _, _, tm, tree = models(arch, 1.0)
    cfg, sd = tm.cfg, tm.state_dict()
    p = tm.period
    seen = set()
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        keys = [k.key for k in path]
        if keys[0] == "layers":
            j, rest = int(keys[1]), ".".join(keys[2:])
            names = [(f"layers.{g * p + j}.{rest}", g) for g in range(cfg.n_layers // p)]
        elif keys[0] == "encoder" and keys[1] != "final_norm":
            rest = ".".join(keys[1:])
            names = [(f"encoder.layers.{i}.{rest}", i) for i in range(cfg.n_encoder_layers)]
        else:
            names = [(".".join(keys), None)]
        for name, i in names:
            assert name not in seen, name
            seen.add(name)
            np.testing.assert_array_equal(sd[name].numpy(), leaf if i is None else leaf[i],
                                          err_msg=name)
    assert seen == set(sd)
    assert (tm.enc_proj is not None) == (arch == VLM)
    assert (tm.encoder is not None) == (arch == AUDIO)
    assert tm.cross_layers == ([3, 8] if arch == VLM else [0, 1])
    assert tm.attn_layers == ([l for l in range(10) if l not in (3, 8)] if arch == VLM else [])
    bf = dataclasses.replace(cfg, param_dtype="bfloat16", compute_dtype="bfloat16")
    sd16 = params_from_numpy(tree, bf, "cpu")
    x = tm.cross_layers[0]
    assert sd16[f"layers.{x}.gate_attn"].dtype == torch.float32
    assert sd16[f"layers.{x}.xattn.wk"].dtype == torch.bfloat16
    assert tuple(sd16[f"layers.{x}.xattn.wk"].shape) == (
        cfg.d_model if arch == VLM else cfg.d_enc, cfg.n_kv_heads * cfg.head_dim)


def test_init_scheme_of_cross_layers():
    """The port's init sets ``lnx`` and ``gate_attn`` to 1 and the encoder's
    ``w_down`` at its own depth (2 layers: 0.02 / 2), as the reference's
    init does."""
    cfg = tconfigs.reduced(tconfigs.get_config(AUDIO))
    m = Model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    _, _, _, tree = models(AUDIO, 1.0)
    for layer in m.layers:
        assert torch.all(layer.lnx == 1) and layer.gate_attn.item() == 1.0
        assert layer.gate_attn.dtype == torch.float32
    np.testing.assert_array_equal(tree["layers"]["0"]["gate_attn"], 1.0)
    std = m.encoder.layers[0].ffn.w_down.std().item()
    assert abs(std - 0.02 / 2.0) < 2e-3
    assert abs(float(np.std(tree["encoder"]["ffn"]["w_down"])) - 0.02 / 2.0) < 2e-3


@pytest.mark.parametrize("arch", ARCHS)
def test_encode_and_nocache_logits_match_reference(arch):
    """``Model.encode`` (the vision model's projection, SeamlessM4T's
    encoder) within 1e-5 and the cacheless forward's logits within 1e-4."""
    jm, params, tm, _ = models(arch, 1.0)
    toks, enc = inputs(tm.cfg, seed=2)
    want_enc = jm.encode(params, jnp.asarray(enc))
    got_enc = tm.encode(torch.from_numpy(enc))
    assert got_enc.dtype == torch.float32
    _close(got_enc, want_enc, atol=1e-5)
    want, _ = jm.forward(params, jnp.asarray(toks), enc_embeds=jnp.asarray(enc))
    pos = torch.arange(PL, dtype=torch.int32)[None].expand(2, PL).contiguous()
    got = tm.logits(tm.run_layers(tm.embed_tokens(torch.from_numpy(toks)),
                                  TCtx(positions=pos, enc_out=got_enc)))
    _close(got, want)


@pytest.mark.parametrize("arch", ARCHS)
def test_cross_planes_after_prefill_and_decode(arch):
    """A prefill owning row 0 only (``scatter_mask``), group by group, then a
    skip decode of 5 scrambled block rows shrunk to 2 at the group-1
    boundary: row 0's hidden state after each group within 1e-4 of the
    reference's; after the prefill the cross planes of row 0 (and the
    vision model's K/V planes) within 1e-4, row 1's cross planes still
    zero; the decode reads the cross planes and leaves them as they were."""
    jm, params, tm, _ = models(arch, 1.0)
    cfg, p = tm.cfg, tm.period
    b, t, lb = 2, 32, 8
    rng = np.random.default_rng(3)
    tokens = rng.integers(0, cfg.vocab_size, (b, t)).astype(np.int32)
    enc = rng.normal(size=(b, cfg.n_enc_tokens, cfg.d_enc)).astype(np.float32)
    pos = np.tile(np.arange(t, dtype=np.int32), (b, 1))
    jenc = jm.encode(params, jnp.asarray(enc))
    tenc = tm.encode(torch.from_numpy(enc))
    jcache = jm.init_cache(b, t, lb)
    tcache = tm.init_cache(b, t, block_len=lb)
    assert isinstance(tcache, EncDecCache) and (tcache.kv is None) == (arch == AUDIO)
    own = torch.tensor([True, False])
    jctx = JCtx(positions=jnp.asarray(pos), mode="prefill", kv_pos=jnp.asarray(pos),
                slot_idx=jnp.asarray(pos), enc_out=jenc)
    tctx = TCtx(torch.from_numpy(pos), "prefill", kv_pos=torch.from_numpy(pos),
                slot_idx=torch.from_numpy(pos), scatter_mask=own, enc_out=tenc)
    jh = jm.embed(params, jnp.asarray(tokens))
    th = tm.embed_tokens(torch.from_numpy(tokens))
    for g in range(tm.n_groups):
        out = jm.run_layers(params, jh, jctx, jcache, group_lo=g, group_hi=g + 1)
        jh, jcache = out.h, out.caches
        th = tm.run_layers(th, tctx, tcache, group_lo=g, group_hi=g + 1)
        # row 1 reads the self-attention K/V the pass did not write: its
        # output is the one the engine merges away
        _close(th[0], jh[0], err_msg=f"prefill group {g}")

    def planes_close(what):
        for l in range(cfg.n_layers):
            g, j = divmod(l, p)
            if l in tm.cross_plane:
                i = tm.cross_plane[l]
                for name in ("k", "v"):
                    got = getattr(tcache.cross, name)[i]
                    _close(got[0], getattr(jcache["cross"][str(j)], name)[g][0],
                           err_msg=f"{what}: layer {l} cross {name}")
                    assert not got[1].any(), f"{what}: row 1 is not the pass's"
            elif l in tm.kv_plane:
                i = tm.kv_plane[l]
                _close(tcache.kv.k[i][0], jcache["kv"][str(j)].k[g][0], err_msg=f"{what}: {l} K")
    planes_close("prefill")
    cross_before = [t.clone() for t in tcache.cross]
    s_idx = np.stack([rng.permutation(lb)[:5] for _ in range(b)]).astype(np.int32)
    keep = np.array([[3, 0], [1, 4]])
    bs = np.array([16, 16], np.int32)
    blk = np.take_along_axis(tokens, bs[:, None] + s_idx, 1)
    jh, th = jm.embed(params, jnp.asarray(blk)), tm.embed_tokens(torch.from_numpy(blk))
    for g in range(tm.n_groups):
        if g == 1:
            s_idx = np.take_along_axis(s_idx, keep, 1)
            jh = jnp.take_along_axis(jh, jnp.asarray(keep)[..., None], axis=1)
            th = torch.gather(th, 1, torch.from_numpy(keep)[..., None].expand(-1, -1,
                                                                              th.shape[-1]))
        rows = bs[:, None] + s_idx
        jctx = JCtx(positions=jnp.asarray(rows), mode="decode", kv_pos=jnp.asarray(pos),
                    slot_idx=jnp.asarray(rows), block_idx=jnp.asarray(s_idx), enc_out=jenc)
        tctx = TCtx(torch.from_numpy(rows), "decode", kv_pos=torch.from_numpy(pos),
                    slot_idx=torch.from_numpy(rows), block_idx=torch.from_numpy(s_idx))
        out = jm.run_layers(params, jh, jctx, jcache, group_lo=g, group_hi=g + 1)
        jh, jcache = out.h, out.caches
        th = tm.run_layers(th, tctx, tcache, group_lo=g, group_hi=g + 1)
        _close(th[0], jh[0], err_msg=f"decode group {g}")
    for before, after in zip(cross_before, tcache.cross):
        assert torch.equal(before, after)
    planes_close("decode")


def _runs(arch):
    st = stages(tconfigs.reduced(tconfigs.get_config(arch)))
    runs = {"es": dict(mode="es", skip_stages=st), "dualcache": dict(mode="dualcache"),
            "vanilla": dict(mode="vanilla"),
            "es_sampled": dict(mode="es", skip_stages=st, temperature=0.8)}
    if arch == VLM:
        runs["es_int8"] = dict(mode="es", skip_stages=st)
    else:
        runs["dualcache_sampled"] = dict(mode="dualcache", temperature=0.8)
    return runs


@pytest.mark.parametrize("arch,run", [(a, r) for a in ARCHS for r in _runs(a)])
def test_generate_tokens_identical(arch, run):
    """Offline generation at x10 weights, one ``enc_embeds`` a row: the
    port's tokens equal the JAX engine's.  The es runs take
    ``default_skip_stages``, which round to group boundary 1."""
    jm, params, tm, _ = models(arch)
    jgen, tgen = gen_configs(**_runs(arch)[run])
    kw = dict(kv_cache_dtype="int8") if run == "es_int8" else {}
    prompt, enc = inputs(tm.cfg)
    want = np.asarray(jmake(jm, jgen, importance_impl="pallas", **kw).generate(
        params, jnp.asarray(prompt), jax.random.PRNGKey(0), enc_embeds=jnp.asarray(enc)))
    engine = tmake(tm, tgen, device="cpu", **kw)
    got = engine.generate(torch.from_numpy(prompt), enc_embeds=torch.from_numpy(enc))
    np.testing.assert_array_equal(got.numpy(), want)
    sampled = tgen.temperature > 0
    if arch == VLM or sampled:
        assert len(np.unique(want[:, PL:])) >= 4, "degenerate reference output"
    if tgen.mode != "vanilla":
        # greedy SeamlessM4T: every [mask] row of a block ties, so the
        # block's prefill unmasks all of it
        decodes = engine.pass_counts["skip"] + engine.pass_counts["noskip"]
        assert (decodes > 0) == (arch == VLM or sampled), engine.pass_counts
    if kw:
        assert engine.last_state.cache.kv.quantized
        assert engine.last_state.cache.cross.k.dtype == torch.float32
    if tgen.mode == "es":
        assert [(s.group_lo, s.group_hi, s.keep_k) for s in engine.segments] == [
            (0, 1, 2), (1, 2, None)]


@pytest.mark.parametrize("arch", ARCHS)
def test_refusals_match_reference(arch):
    """The adaptive cache and ``gather_refresh`` are refused by both engines
    at construction; sparse attention by the reference's on the vision
    model (period 5), while on SeamlessM4T (period 1) it passes that check
    and fails in ``generate`` where its probe reads a K/V cache the decoder
    does not have.  The port refuses all three at construction."""
    jm, params, tm, _ = models(arch)
    st = stages(tm.cfg)
    adaptive = dict(mode="es", skip_stages=st, cache_prompt_interval=2)
    sparse = dict(mode="es", skip_stages=st, sparse_attention=True)
    for kw, ekw, match in ((adaptive, {}, "adaptive feature cache"),
                           (dict(mode="es", skip_stages=st),
                            dict(paged=True, page_size=8, gather_refresh=True),
                            "gather_refresh"),
                           (sparse, {}, "sparse attention")):
        jgen, tgen = gen_configs(**kw)
        with pytest.raises(ValueError, match=match):
            tmake(tm, tgen, device="cpu", **ekw)
        if kw is sparse and arch == AUDIO:
            engine = jmake(jm, jgen)
            prompt, enc = inputs(tm.cfg)
            with pytest.raises(Exception):
                engine.generate(params, jnp.asarray(prompt), jax.random.PRNGKey(0),
                                enc_embeds=jnp.asarray(enc))
        else:
            with pytest.raises(AssertionError):
                jmake(jm, jgen, **ekw)
