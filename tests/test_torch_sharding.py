"""The port's sharding rules (``repro_torch/sharding/specs.py``) against the
reference's (``repro/sharding/specs.py``), shapes only, through the
reference tests' ``FakeMesh`` idiom (``tests/test_sharding_hlo.py``).

Every leaf of every registered arch's parameters at full size, on both
production meshes, in train and serve mode: the port's spec (with the
arch's head width, the rules its tensor parallelism runs) equals the
reference's, or differs in one of the divergences ``specs.DIVERGENCES``
names, which this file lists by leaf (``divergence``).  The cache leaves of
every attention arch (dense, ``B`` 128 and 1, paged, int8 scales, cross
planes), the SSM caches of mamba2 and Jamba, the ``EngineState`` and
``BlockState`` specs, ``local_slice`` and ``port_param_spec`` on the port's
unstacked leaves are checked the same way.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import build_model as jbuild
from repro.sharding import specs as jspecs
from repro.utils.tree import flatten_with_paths
from repro_torch import configs as tconfigs
from repro_torch.sharding import specs


class FakeMesh:
    """Duck-typed mesh for spec rules (shape + axis_names only)."""
    def __init__(self, shape):
        self.shape = dict(shape)
        self.axis_names = tuple(shape)


MESHES = {"single": {"data": 16, "model": 16}, "multi": {"pod": 2, "data": 16, "model": 16}}
ARCHS = tconfigs.list_archs()
# the divergences each arch's parameters show on the production meshes, by
# leaf: 16 does not divide the query heads of dream (28), gemma3 (4) and
# qwen2 (12); it is a multiple of the KV heads of chatglm3 (2), dream (4),
# gemma3 (1), granite-moe (8), jamba (8), the vision model (8), llama3 (8)
# and qwen2 (2); the qkv biases (chatglm3, dream, qwen2) follow their heads
# where the query heads divide; every MoE router stays whole; the mixers
# of mamba2 and jamba cut their norm scale and per-head leaves with their
# SSM heads (the reference cuts the rest of a head's leaves alike, flat)
# and keep B and C whole
_QKV, _KV, _Q = {"bq", "bk", "bv"}, {"wk", "wv"}, {"wq", "wo", "bq"}
_SSM = {"ssm_heads": {"norm_scale", "a_log", "dt_bias", "d_skip"},
        "ssm_groups": {"bc_proj", "conv_bc", "conv_bcb"}}
EXPECTED = {
    "chatglm3-6b": {"qkv_bias": _QKV, "kv_heads": _KV},
    "dream-7b": {"qkv_bias": {"bk", "bv"}, "heads": _Q, "kv_heads": _KV},
    "gemma3-1b": {"heads": {"wq", "wo"}, "kv_heads": _KV},
    "granite-moe-1b-a400m": {"kv_heads": _KV, "router": {"router"}},
    "jamba-v0.1-52b": {"kv_heads": _KV, "router": {"router"}, **_SSM},
    "llada-8b": {},
    "llama-3.2-vision-11b": {"kv_heads": _KV},
    "llama3-8b": {"kv_heads": _KV},
    "mamba2-370m": _SSM,
    "olmoe-1b-7b": {"router": {"router"}},
    "qwen2-1.5b": {"qkv_bias": {"bk", "bv"}, "heads": _Q, "kv_heads": _KV},
    "seamless-m4t-large-v2": {},
}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def norm(spec, ndim: int) -> tuple:
    """A spec as a tuple of ``ndim`` entries (a PartitionSpec's trailing
    Nones are implicit; a one-axis tuple is that axis)."""
    spec = tuple(a[0] if isinstance(a, tuple) and len(a) == 1 else a for a in spec)
    return spec + (None,) * (ndim - len(spec))


def divergence(name: str, ref: tuple, port) -> str | None:
    """The divergence of ``specs.DIVERGENCES`` a parameter leaf's differing
    spec shows, or None (a fault).  ``port`` is "raises" where the port's
    rule raised ValueError."""
    if port == "raises":
        return {"wq": "heads", "wo": "heads", "bq": "heads"}.get(name) or \
            ("kv_heads" if name in ("wk", "wv", "bk", "bv") else None)
    heads = port[-1]
    if name in ("bc_proj", "conv_bc", "conv_bcb") and not any(port) and "model" in ref:
        return "ssm_groups"
    if name in ("norm_scale", "a_log", "dt_bias", "d_skip") and heads == "model" \
            and not any(ref):
        return "ssm_heads"
    if name in ("bq", "bk", "bv") and heads is not None and not any(ref):
        return "qkv_bias"
    if name == "router" and not any(port) and "model" in ref:
        return "router"
    if name in ("wk", "wv") and isinstance(heads, specs.Grouped):
        return "kv_heads"
    return None


def _ref_params(arch: str) -> dict:
    model = jbuild(jconfigs.get_config(arch))
    return flatten_with_paths(jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0))))


@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_match_reference(arch):
    cfg = tconfigs.get_config(arch)
    seen: dict = {}
    for mesh_name, sizes in MESHES.items():
        mesh = FakeMesh(sizes)
        for mode in ("train", "serve"):
            for path, leaf in _ref_params(arch).items():
                shape = tuple(leaf.shape)
                ref = norm(jspecs.param_spec(path, shape, mesh, mode=mode), len(shape))
                try:
                    port = norm(specs.param_spec(path, shape, sizes, mode=mode,
                                                 head_dim=cfg.head_dim, ssm=cfg.ssm),
                                len(shape))
                except ValueError:
                    port = "raises"
                # without the head width the rules are the reference's
                assert norm(specs.param_spec(path, shape, mesh, mode=mode), len(shape)) == ref
                if port == ref:
                    continue
                name = specs.leaf_name(path)
                why = divergence(name, ref, port)
                assert why in specs.DIVERGENCES, (arch, mesh_name, mode, path, ref, port)
                seen.setdefault(why, set()).add(name)
    assert seen == EXPECTED[arch]


def test_divergence_table_names_every_divergence():
    doc = specs.__doc__
    for name in specs.DIVERGENCES:
        assert f"\n{name} " in doc, name


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_cache_specs_match_reference(mesh_name):
    sizes = MESHES[mesh_name]
    mesh = FakeMesh(sizes)
    checked = 0
    for arch in ARCHS:
        cfg = tconfigs.get_config(arch)
        if not cfg.n_kv_heads:
            continue
        h, d, g = cfg.n_kv_heads, cfg.head_dim, 4
        for kind, shape, paged in (("kv", (g, 128, 32768, h, d), False),
                                   ("kv", (g, 128, 32768, h), False),
                                   ("kv", (g, 1, 524288, h, d), False),
                                   ("kv", (g, 4097, 16, h, d), True),
                                   ("kv", (g, 4097, 16, h), True),
                                   ("cross", (g, 128, 1601, h, d), False)):
            ref = norm(jspecs.cache_leaf_spec(kind, shape, mesh, paged=paged), len(shape))
            try:
                port = norm(specs.cache_leaf_spec(kind, shape, sizes, paged=paged), len(shape))
            except ValueError:
                port = "raises"
            checked += 1
            if port == ref:
                continue
            if shape[1] == 1 and not paged:
                # long_context: the reference cuts S over (data, model)
                assert ref[2] == ("data", "model")
                assert port == "raises" or port[:3] == (None, None, None)
                continue
            # kv_heads: whole KV heads, or each rank's one KV head
            assert port == "raises" or isinstance(port[3], specs.Grouped), (arch, shape, port)
            assert port != "raises" or (h % 16 and 16 % h), (arch, shape)
    assert checked > 40


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ["mamba2-370m", "jamba-v0.1-52b"])
def test_ssm_cache_specs_match_reference(arch, mesh_name):
    """The SSM caches of a served batch of 128 at full width: the SSD state
    keeps the reference's heads on ``model``; the conv tail differs in
    ``ssm_conv_tail`` (each rank's x channels, then every B/C channel,
    where the reference cuts the channels flat); ``ssmh`` in
    ``activations`` (replicated, where the reference puts ``d`` on
    ``model``)."""
    from repro_torch.models.mamba import mamba_dims

    sizes = MESHES[mesh_name]
    mesh = FakeMesh(sizes)
    cfg = tconfigs.get_config(arch)
    s, dims = cfg.ssm, mamba_dims(cfg)
    g, b = cfg.n_layers, 128
    state = (g, b, dims["n_heads"], s.d_state, s.headdim)
    tail = (g, b, s.conv_width - 1, dims["conv_ch"])
    ssmh = (g, b, 64, cfg.d_model)
    ref = {k: norm(jspecs.cache_leaf_spec(kind, shape, mesh), len(shape))
           for k, kind, shape in (("state", "ssm", state), ("tail", "ssm", tail),
                                  ("ssmh", "ssmh", ssmh))}
    assert norm(specs.cache_leaf_spec("ssm", state, sizes), 5) == ref["state"] == \
        (None, "data", "model", None, None)
    port = norm(specs.cache_leaf_spec("ssm", tail, sizes, d_inner=dims["d_inner"]), 4)
    assert ref["tail"] == (None, "data", None, "model")
    assert port == (None, "data", None, specs.Leading("model", dims["d_inner"]))
    bc = dims["conv_ch"] - dims["d_inner"]
    assert specs.local_shape(tail, port, sizes) == (g, 8, 3, dims["d_inner"] // 16 + bc)
    assert norm(specs.cache_leaf_spec("ssmh", ssmh, sizes), 4) == (None, "data", None, None)
    assert ref["ssmh"] == (None, "data", None, "model")
    with pytest.raises(ValueError, match="d_inner"):
        specs.cache_leaf_spec("ssm", tail, sizes)
    # the same specs through cache_pspecs of a port SSMCache
    from repro_torch.models.mamba import SSMCache

    fake = SSMCache(*(torch.empty(()).expand(*shape) for shape in (state, tail, ssmh)))
    got = specs.cache_pspecs(fake, sizes)
    assert got.conv_tail[3] == specs.Leading("model", dims["d_inner"])
    # a rank's tail: its x channels, then every B/C channel
    full = np.arange(2 * dims["conv_ch"]).reshape(1, 1, 2, dims["conv_ch"])
    one = specs.local_slice(full, (None, None, None, port[3]), sizes, {"model": 3})
    w = dims["d_inner"] // 16
    np.testing.assert_array_equal(one, np.concatenate(
        [full[..., 3 * w:4 * w], full[..., dims["d_inner"]:]], axis=-1))


def _engines():
    """Reduced LLaDA (4 KV heads: Grouped at model=16) in both packages, paged,
    with the adaptive cache so ``feat``/``conf_full`` are populated."""
    from repro.core.engine import DiffusionEngine as JEngine
    from repro_torch.core.engine import DiffusionEngine
    from repro_torch.models import Model

    jcfg = dataclasses.replace(jconfigs.reduced(jconfigs.get_config("llada-8b")), n_layers=2)
    tcfg = dataclasses.replace(tconfigs.reduced(tconfigs.get_config("llada-8b")), n_layers=2)
    kw = dict(mode="es", gen_length=8, block_length=8, prompt_refresh_period=8,
              block_refresh_period=4, cache_prompt_interval=2)
    jgen = jconfigs.GenerationConfig(skip_stages=(jconfigs.SkipStage(1, 0.5),), **kw)
    tgen = tconfigs.GenerationConfig(skip_stages=(tconfigs.SkipStage(1, 0.5),), **kw)
    jeng = JEngine(jbuild(jcfg), jgen, paged=True, page_size=8)
    teng = DiffusionEngine(Model(tcfg, device="cpu"), tgen, device="cpu", paged=True,
                           page_size=8)
    return jeng, teng


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_engine_and_block_state_specs_match_reference(mesh_name):
    sizes = MESHES[mesh_name]
    mesh = FakeMesh(sizes)
    jeng, teng = _engines()
    jst = jax.eval_shape(lambda: jeng.init_engine_state(16, 8, jax.random.PRNGKey(0)))
    tst = teng.init_engine_state(16, 8)
    jsp = jspecs.engine_state_pspecs(jst, mesh, paged=True)
    tsp = specs.engine_state_pspecs(tst, sizes, paged=True)
    for field in tst._fields:
        value = getattr(tst, field)
        if value is None:
            assert getattr(tsp, field) is None, field
            continue
        port = getattr(tsp, field)
        if field == "cache":
            for t, j, spec in ((tst.cache.k, jst.caches["kv"]["0"].k, port.k),
                               (tst.cache.v, jst.caches["kv"]["0"].v, port.v)):
                ref = norm(jspecs.cache_leaf_spec("kv", j.shape, mesh, paged=True), j.ndim)
                # kv_heads: the pool's 4 KV heads, Grouped over model=16
                assert norm(spec, t.dim())[:3] == ref[:3] == (None, None, None)
                assert spec[3] == specs.Grouped("model", 4) and ref[3] is None
            continue
        if field == "hidden":
            for t, j, spec in zip(value, jst.hidden, port):
                ref = norm(jsp.hidden[0], j.ndim)
                # activations: d replicated, the reference's d on model
                assert norm(spec, t.dim()) == ref[:2] + (None,) and ref[2] == "model"
            continue
        ref = getattr(jsp, field)
        if field == "feat":
            assert norm(port, 3) == norm(ref, 3)[:2] + (None,) and norm(ref, 3)[2] == "model"
            continue
        assert norm(port, value.dim()) == norm(ref, value.dim()), field
    # the offline block state: the same rules
    jb = jax.eval_shape(lambda: jeng.make_block_state(jax.numpy.zeros((16, 16), "int32"),
                                                      jax.random.PRNGKey(0)))
    tb = teng.make_block_state(torch.zeros((16, 16), dtype=torch.int32))
    jbs = jspecs.block_state_pspecs(jb, mesh)
    tbs = specs.block_state_pspecs(tb, sizes)
    for field in ("tokens", "conf", "pred", "kv_valid"):
        assert norm(getattr(tbs, field), 2) == norm(getattr(jbs, field), 2), field
    assert tbs.t == () and tuple(jbs.t) == ()
    # kv_heads: the pool's 4 KV heads, Grouped over model=16
    assert tbs.cache.k[3] == specs.Grouped("model", 4)


def test_local_slice_and_shapes():
    sizes = {"data": 2, "model": 4}
    full = np.arange(8 * 12).reshape(8, 12)
    for c in range(4):
        got = specs.local_slice(full, (None, "model"), sizes, {"model": c, "data": 1})
        np.testing.assert_array_equal(got, full[:, 3 * c:3 * c + 3])
        # Grouped: 2 pieces over 4 ranks, piece c * 2 // 4
        got = specs.local_slice(full, (specs.Grouped("model", 2),), sizes, {"model": c})
        np.testing.assert_array_equal(got, full[4 * (c // 2):4 * (c // 2) + 4])
    # a tuple of axes: the first major
    got = specs.local_slice(full, (("data", "model"),), sizes, {"data": 1, "model": 2})
    np.testing.assert_array_equal(got, full[6:7])
    assert specs.local_shape((8, 12), (("data", "model"), "model"), sizes) == (1, 3)
    assert specs.local_shape((8, 12), (specs.Grouped("model", 2),), sizes) == (4, 12)
    with pytest.raises(ValueError):
        specs.local_slice(full, ("model", None), {"model": 3}, {"model": 0})


@pytest.mark.parametrize("arch", ["llada-8b", "dream-7b", "olmoe-1b-7b", "llama3-8b",
                                  "mamba2-370m", "jamba-v0.1-52b", "llama-3.2-vision-11b",
                                  "seamless-m4t-large-v2"])
def test_port_param_spec_matches_reference_layout(arch):
    """``port_param_spec`` of an unstacked port leaf (the decoder's, the
    encoder's, the mixer's) is the stacked reference leaf's spec without
    the group dim, at model 16."""
    cfg = tconfigs.get_config(arch)
    sizes = {"model": 16}
    kw = dict(ssm=cfg.ssm)
    for path, leaf in _ref_params(arch).items():
        parts = path.split("/")
        if parts[0] not in ("layers", "encoder") or parts[-1] == "final_norm":
            name, shape = path.replace("/", "."), tuple(leaf.shape)
            want = specs.param_spec(path, shape, sizes, mode="serve", head_dim=cfg.head_dim,
                                    **kw)
        else:
            # layers/j/... -> layers.j...; encoder/... -> encoder.layers.0...
            name = ".".join(["layers", parts[1]] + parts[2:] if parts[0] == "layers"
                            else ["encoder", "layers", "0"] + parts[1:])
            shape = tuple(leaf.shape[1:])
            try:
                want = specs.param_spec(path, tuple(leaf.shape), sizes, mode="serve",
                                        head_dim=cfg.head_dim, **kw)[1:]
            except ValueError:
                with pytest.raises(ValueError):
                    specs.port_param_spec(name, shape, sizes, cfg.head_dim, **kw)
                continue
        assert specs.port_param_spec(name, shape, sizes, cfg.head_dim, **kw) == want, path
