"""The port's configs, building blocks and layer stack against the JAX reference.

Reduced LLaDA-8B (MHA) and Dream-7B (GQA + qkv bias) with 4 layers: the
reference's random-init parameters, as numpy arrays, are converted for the
port; the same tokens go through both stacks in the three cache modes.
Float32 on both sides; 1e-4 abs covers summation-order differences.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import common as jcommon
from repro.models.model import ForwardCtx as JCtx, build_model as jbuild
from repro_torch import configs as tconfigs
from repro_torch.convert import params_from_numpy
from repro_torch.models import common as tcommon
from repro_torch.models.model import ForwardCtx as TCtx, Model

ARCHS = ["llada-8b", "dream-7b"]
ATOL = 1e-4
SEGMENTS = [(0, 1), (1, 3), (3, 4)]


def build_pair(arch, *, n_layers=4, scale=1.0, seed=0):
    """(reference model, reference params, port model) from one parameter tree."""
    jcfg = dataclasses.replace(jconfigs.reduced(jconfigs.get_config(arch)), n_layers=n_layers)
    tcfg = dataclasses.replace(tconfigs.reduced(tconfigs.get_config(arch)), n_layers=n_layers)
    jm = jbuild(jcfg)
    tree = jax.tree_util.tree_map(
        lambda a: np.asarray(a) * (scale if a.ndim >= 2 else 1.0), jm.init(jax.random.PRNGKey(seed)))
    tm = Model(tcfg, device="cpu")
    tm.load_state_dict(params_from_numpy(tree, tcfg, "cpu"))
    return jm, jax.tree_util.tree_map(jnp.asarray, tree), tm


def _close(got: torch.Tensor, want, atol=ATOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=atol, rtol=0)


@pytest.mark.parametrize("arch", ARCHS + ["mamba2-370m", "olmoe-1b-7b", "granite-moe-1b-a400m",
                                  "gemma3-1b", "llama3-8b", "qwen2-1.5b", "chatglm3-6b",
                                  "jamba-v0.1-52b", "llama-3.2-vision-11b",
                                  "seamless-m4t-large-v2"])
def test_configs_match_reference(arch):
    full_j, full_t = jconfigs.get_config(arch), tconfigs.get_config(arch)
    assert dataclasses.asdict(full_j) == dataclasses.asdict(full_t)
    assert dataclasses.asdict(jconfigs.reduced(full_j)) == dataclasses.asdict(tconfigs.reduced(full_t))
    assert full_t.pattern_period == full_j.pattern_period == {
        "jamba-v0.1-52b": 8, "llama-3.2-vision-11b": 5}.get(arch, 1)
    for n in (4, 28, 32):
        assert ([dataclasses.astuple(s) for s in jconfigs.default_skip_stages(n)]
                == [dataclasses.astuple(s) for s in tconfigs.default_skip_stages(n)])
    assert ([f.name for f in dataclasses.fields(jconfigs.GenerationConfig)]
            == [f.name for f in dataclasses.fields(tconfigs.GenerationConfig)])
    assert (dataclasses.asdict(jconfigs.GenerationConfig())
            == dataclasses.asdict(tconfigs.GenerationConfig()))


@pytest.mark.parametrize("arch", ARCHS)
def test_padded_vocab_reserves_the_mask_row(arch):
    """Reduced: both round 503 up to 512.  Full size: the vocab is already a
    multiple of 256, so the port adds a block of 256 for the [mask] row
    (the reference's ``jnp.take`` fills that out-of-range row with NaN)."""
    red_j = jconfigs.reduced(jconfigs.get_config(arch))
    red_t = tconfigs.reduced(tconfigs.get_config(arch))
    assert tcommon.padded_vocab(red_t) == jcommon.padded_vocab(red_j) == 512
    full = tconfigs.get_config(arch)
    assert full.vocab_size % 256 == 0
    assert tcommon.padded_vocab(full) == full.vocab_size + 256


@pytest.mark.parametrize("fraction", [1.0, 0.5])
def test_common_blocks_match_reference(fraction):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 4, 32), np.float32)
    pos = rng.integers(0, 200, (2, 5)).astype(np.int32)
    want = jcommon.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta=500_000.0, fraction=fraction)
    got = tcommon.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), theta=500_000.0,
                             fraction=fraction)
    _close(got, want, atol=1e-5)
    h = rng.standard_normal((2, 5, 64), np.float32)
    scale = rng.standard_normal(64).astype(np.float32)
    _close(tcommon.rms_norm(torch.from_numpy(h), torch.from_numpy(scale), 1e-6),
           jcommon.rms_norm(jnp.asarray(h), jnp.asarray(scale), 1e-6), atol=1e-5)
    w = {n: rng.standard_normal(s, np.float32) * 0.1
         for n, s in (("w_gate", (64, 96)), ("w_up", (64, 96)), ("w_down", (96, 64)))}
    tw = type("W", (), {n: torch.from_numpy(a) for n, a in w.items()})
    _close(tcommon.mlp_apply(tw, torch.from_numpy(h), "silu"),
           jcommon.mlp_apply({n: jnp.asarray(a) for n, a in w.items()}, jnp.asarray(h), "silu"),
           atol=1e-5)


@pytest.mark.parametrize("arch", ARCHS)
def test_converter_layout(arch):
    jm, params, tm = build_pair(arch)
    cfg = tm.cfg
    sd = tm.state_dict()
    assert set(sd) == set(params_from_numpy(jax.tree_util.tree_map(np.asarray, params), cfg, "cpu"))
    np.testing.assert_array_equal(sd["layers.2.attn.wk"].numpy(),
                                  np.asarray(params["layers"]["0"]["attn"]["wk"][2]))
    assert ("layers.0.attn.bq" in sd) == cfg.qkv_bias
    assert sd["embed"].shape == params["embed"].shape
    assert sd["lm_head"].shape == params["lm_head"].shape


@pytest.mark.parametrize("arch", ARCHS)
def test_embed_logits_and_nocache_stack(arch):
    jm, params, tm = build_pair(arch)
    tokens = np.random.default_rng(1).integers(0, tm.cfg.vocab_size + 1, (2, 24)).astype(np.int32)
    tokens[:, -8:] = tm.cfg.vocab_size               # [mask] ids embed too
    jh = jm.embed(params, jnp.asarray(tokens))
    th = tm.embed_tokens(torch.from_numpy(tokens))
    np.testing.assert_array_equal(th.numpy(), np.asarray(jh))
    pos = np.tile(np.arange(24, dtype=np.int32), (2, 1))
    jout = jm.run_layers(params, jh, JCtx(positions=jnp.asarray(pos), mode="nocache")).h
    tout = tm.run_layers(th, TCtx(torch.from_numpy(pos)))
    _close(tout, jout)
    _close(tm.logits(tout), jm.logits(params, jout))


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_segments_match_reference(arch):
    """Segment by segment, as the ES engine runs the stack: the hidden state
    at every segment boundary and the K/V caches after the prefill and after
    a decode pass over an active subset of the last block."""
    jm, params, tm = build_pair(arch)
    b, t, lb = 2, 24, 8
    rng = np.random.default_rng(2)
    tokens = rng.integers(0, tm.cfg.vocab_size, (b, t)).astype(np.int32)
    pos = np.tile(np.arange(t, dtype=np.int32), (b, 1))
    jcache = jm.init_cache(b, t, lb)
    tcache = tm.init_cache(b, t)
    assert tuple(tcache.k.shape) == jcache["kv"]["0"].k.shape

    jctx = JCtx(positions=jnp.asarray(pos), mode="prefill", kv_pos=jnp.asarray(pos),
                slot_idx=jnp.asarray(pos))
    tpos = torch.from_numpy(pos)
    tctx = TCtx(tpos, "prefill", kv_pos=tpos, slot_idx=tpos)
    jh = jm.embed(params, jnp.asarray(tokens))
    th = tm.embed_tokens(torch.from_numpy(tokens))
    for lo, hi in SEGMENTS:
        out = jm.run_layers(params, jh, jctx, jcache, group_lo=lo, group_hi=hi)
        jh, jcache = out.h, out.caches
        th = tm.run_layers(th, tctx, tcache, group_lo=lo, group_hi=hi)
        _close(th, jh)
    _close(tcache.k, jcache["kv"]["0"].k)
    _close(tcache.v, jcache["kv"]["0"].v)

    # decode: 5 active rows of the last block, in a scrambled order
    rows = np.stack([t - lb + rng.permutation(lb)[:5] for _ in range(b)]).astype(np.int32)
    blk_tok = np.take_along_axis(tokens, rows, axis=1)
    jctx = JCtx(positions=jnp.asarray(rows), mode="decode", kv_pos=jnp.asarray(pos),
                slot_idx=jnp.asarray(rows))
    trows = torch.from_numpy(rows)
    tctx = TCtx(trows, "decode", kv_pos=tpos, slot_idx=trows)
    jh = jm.embed(params, jnp.asarray(blk_tok)) * 1.5       # fresh rows differ from the cache
    th = tm.embed_tokens(torch.from_numpy(blk_tok)) * 1.5
    for lo, hi in SEGMENTS:
        out = jm.run_layers(params, jh, jctx, jcache, group_lo=lo, group_hi=hi)
        jh, jcache = out.h, out.caches
        th = tm.run_layers(th, tctx, tcache, group_lo=lo, group_hi=hi)
        _close(th, jh)
    _close(tcache.k, jcache["kv"]["0"].k)
    _close(tcache.v, jcache["kv"]["0"].v)


def test_model_init_scheme():
    """torch's numbers, the reference's scheme: norms 1, biases 0, weights
    N(0, 0.02), output projections N(0, 0.02/sqrt(2L))."""
    cfg = tconfigs.reduced(tconfigs.get_config("dream-7b"))
    m = Model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    assert torch.all(m.layers[0].ln1 == 1) and torch.all(m.layers[1].attn.bq == 0)
    assert abs(m.embed.std().item() - 0.02) < 2e-3
    assert abs(m.layers[0].ffn.w_down.std().item() - 0.02 / (2 * cfg.n_layers) ** 0.5) < 2e-3
    again = Model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    assert torch.equal(m.lm_head, again.lm_head)


def test_unsupported_arch_raises():
    """Logit soft-capping stays outside the port (no config of the repo sets
    it): a LLaDA stack given a non-zero ``logit_softcap`` is refused.
    Cross-attention layers are ported (``test_torch_cross.py``)."""
    capped = dataclasses.replace(tconfigs.reduced(tconfigs.get_config("llada-8b")),
                                 logit_softcap=30.0)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        Model(capped, device="cpu")
