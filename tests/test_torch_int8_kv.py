"""The int8 KV cache in the port, against the JAX reference, on the CPU.

* ``ref.quantize_rows`` equals the reference's ``_quantize_rows`` bit for
  bit, zero rows and .5 ties included;
* the plain int8 attention (dense and paged, with the window and
  block-causal options, and by the split-KV algebra) is within 1e-5 of the
  reference's ``ops.attention``/``paged_attention`` given the scales;
* the plain quantizing scatter (dense and paged, with the serving masks)
  equals ``_quantize_rows`` and the reference's scatters bit for bit;
* ``kv_cache_dtype="int8"`` es tokens equal the JAX engine's, dense and
  paged, on reduced LLaDA and Dream; paged equals dense, and int8 agrees
  with the full-precision cache on more than 90% of the tokens;
* the sparse probe scores the int8 codes without their scales, in both
  packages (a reference-side fault the port mirrors), and int8 + sparse
  retained sets equal the JAX engine's;
* int8 serving with prefix sharing and with preemption gives the JAX
  scheduler's tokens and gauges, and the page operations move every plane.

Reduced models (4 layers) from ``test_torch_engine``; torch on one
intra-op thread (module fixture).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import make_engine as jmake
from repro.kernels import ops as jops
from repro.models.attention import KVCache as JKVCache
from repro.models.attention import _quantize_rows
from repro.runtime import Request as JRequest
from repro.runtime import StreamScheduler as JScheduler
from repro_torch.core import make_engine as tmake
from repro_torch.kernels import ref
from repro_torch.models.attention import KVCache, QuantKVCache
from repro_torch.runtime import Request, StreamScheduler
from test_torch_engine import MODES, PROMPT_LEN, gen_configs, models, prompt_for
from test_torch_sparse import SCALE as SPARSE_SCALE
from test_torch_sparse import _gens as sparse_gens
from test_torch_sparse import _jax_keeps, _torch_keeps

PS = 8
INT8 = dict(kv_cache_dtype="int8")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rows(rng, *shape):
    """Rows with a zero row and exact .5 ties: row 1 of head 0 has amax 127
    (scale 1.0) and values k + 0.5."""
    x = rng.standard_normal(shape).astype(np.float32)
    x[0, 0, 0] = 0.0
    ties = np.arange(shape[-1], dtype=np.float32) % 9 - 4.5
    ties[0] = 127.0
    x[0, 1, 0] = ties
    return x


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_rows_bit_equal_reference(dtype):
    x = _rows(np.random.default_rng(0), 3, 24, 4, 32)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    jx = jnp.asarray(tx.float().numpy()).astype(getattr(jnp, dtype))
    codes, scales = ref.quantize_rows(tx)
    jc, js = _quantize_rows(jx)
    assert codes.dtype == torch.int8 and scales.dtype == torch.float32
    np.testing.assert_array_equal(codes.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(scales.numpy(), np.asarray(js))
    assert scales[0, 0, 0].item() == np.float32(1e-8) and not codes[0, 0, 0].any()
    want_ties = np.round(x[0, 1, 0]).astype(np.int8)          # ties to even
    np.testing.assert_array_equal(codes[0, 1, 0].numpy(), want_ties)


def _attn_inputs(seed, b=2, hq=4, hkv=2, lq=8, lkv=160, d=32):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, hq, lq, d)).astype(np.float32)
    kc, ks = _quantize_rows(jnp.asarray(rng.standard_normal((b, hkv, lkv, d)), jnp.float32))
    vc, vs = _quantize_rows(jnp.asarray(rng.standard_normal((b, hkv, lkv, d)), jnp.float32))
    q_pos = np.tile(np.arange(lkv - lq, lkv, dtype=np.int32), (b, 1))
    kv_pos = np.tile(np.arange(lkv, dtype=np.int32), (b, 1))
    kv_pos[0, 3:6] = -1
    kv_pos[1, 20:30] = -1
    return q, *(np.array(a) for a in (kc, ks, vc, vs)), q_pos, kv_pos


OPTIONS = {"none": {}, "causal": dict(causal=True), "window+anchor": dict(window=6, anchor=4),
           "block_causal": dict(bc_start=24, bc_block=8),
           "window+bc": dict(window=10, bc_start=24, bc_block=8)}


@pytest.mark.parametrize("opts", list(OPTIONS), ids=list(OPTIONS))
def test_int8_attention_reference_matches_jax(opts):
    kw = OPTIONS[opts]
    q, kc, ks, vc, vs, q_pos, kv_pos = _attn_inputs(1)
    want = np.asarray(jops.attention(*map(jnp.asarray, (q, kc, vc, q_pos, kv_pos)),
                                     k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs), **kw))
    t = [torch.from_numpy(a) for a in (q, kc, vc, q_pos, kv_pos)]
    tks, tvs = torch.from_numpy(ks), torch.from_numpy(vs)
    got = ref.attention_reference(*t, k_scale=tks, v_scale=tvs, **kw)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)
    # the split-KV algebra (the tensor-core body's) over the same codes
    for n_splits in (1, 2):
        split = ref.attention_split_reference(*t, n_splits=n_splits, k_scale=tks, v_scale=tvs,
                                              **kw)
        np.testing.assert_allclose(split.numpy(), want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("opts", ["none", "window+bc"])
def test_int8_paged_attention_reference_matches_jax(opts):
    kw = OPTIONS[opts]
    rng = np.random.default_rng(2)
    b, hq, hkv, lq, d, n_vp = 3, 4, 2, 8, 32, 10
    n_pages = b * n_vp + 2
    q = rng.standard_normal((b, hq, lq, d)).astype(np.float32)
    kc, ks = map(np.array, _quantize_rows(jnp.asarray(
        rng.standard_normal((n_pages, PS, hkv, d)), jnp.float32)))
    vc, vs = map(np.array, _quantize_rows(jnp.asarray(
        rng.standard_normal((n_pages, PS, hkv, d)), jnp.float32)))
    bt = (rng.permutation(n_pages - 1)[:b * n_vp] + 1).reshape(b, n_vp).astype(np.int32)
    bt[1, 0] = -1
    lkv = n_vp * PS
    q_pos = np.tile(np.arange(lkv - lq, lkv, dtype=np.int32), (b, 1))
    kv_pos = np.tile(np.arange(lkv, dtype=np.int32), (b, 1))
    kv_pos[2, 9:14] = -1
    want = np.asarray(jops.paged_attention(
        *map(jnp.asarray, (q, kc, vc, q_pos, kv_pos, bt)), page_size=PS,
        k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs), **kw))
    t = [torch.from_numpy(a) for a in (q, kc, vc, q_pos, kv_pos, bt)]
    sc = dict(k_scale=torch.from_numpy(ks), v_scale=torch.from_numpy(vs))
    got = ref.paged_attention_reference(*t, **sc, **kw)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)
    if not kw:
        split = ref.paged_attention_split_reference(*t, n_splits=2, **sc)
        np.testing.assert_allclose(split.numpy(), want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
@pytest.mark.parametrize("masks", ["none", "row+token"])
def test_quantize_scatter_reference_bit_equal(paged, masks):
    """``ref.quantize_scatter_rows(_paged)_reference`` equals the reference's
    int8 write: ``_quantize_rows`` and four scatters (codes and scales)."""
    rng = np.random.default_rng(3)
    b, s, k, h, d = 3, 32, 6, 2, 16
    n_pages = b * s // PS + 1
    lead = (n_pages, PS) if paged else (b, s)
    codes = rng.integers(-127, 128, (*lead, h, d)).astype(np.int8)
    scales = rng.random((*lead, h)).astype(np.float32)
    new = _rows(rng, b, k, h, d)
    idx = np.stack([rng.permutation(s)[:k] for _ in range(b)]).astype(np.int32)
    bt = (rng.permutation(n_pages - 1) + 1).reshape(b, s // PS).astype(np.int32)
    bt[0, 1] = -1
    mk = {}
    if masks != "none":
        mk = dict(row_mask=np.array([True, False, True]), token_mask=rng.random((b, k)) < 0.5)
    jc, js = _quantize_rows(jnp.asarray(new))
    jmk = {n: jnp.asarray(m) for n, m in mk.items()}
    if paged:
        want = [jops.scatter_rows_paged(jnp.asarray(c), n, jnp.asarray(idx), jnp.asarray(bt),
                                        page_size=PS, **jmk) for c, n in ((codes, jc), (scales, js))]
    else:
        want = [jops.scatter_rows(jnp.asarray(c), n, jnp.asarray(idx), **jmk)
                for c, n in ((codes, jc), (scales, js))]
    tc, ts = torch.from_numpy(codes.copy()), torch.from_numpy(scales.copy())
    tmk = {n: torch.from_numpy(m) for n, m in mk.items()}
    if paged:
        ref.quantize_scatter_rows_paged_reference(tc, ts, torch.from_numpy(new),
                                                  torch.from_numpy(idx), torch.from_numpy(bt),
                                                  **tmk)
    else:
        ref.quantize_scatter_rows_reference(tc, ts, torch.from_numpy(new),
                                            torch.from_numpy(idx), **tmk)
    # paged: page 0 is the garbage page, which the reference also writes
    # with the rows the masks drop
    cut = 1 if paged else 0
    np.testing.assert_array_equal(tc.numpy()[cut:], np.asarray(want[0])[cut:])
    np.testing.assert_array_equal(ts.numpy()[cut:], np.asarray(want[1])[cut:])


def test_int8_cache_layout_and_refusal():
    _, _, tm = models("llada-8b")
    cfg = tm.cfg
    dense = tm.init_cache(2, 32, kv_dtype="int8")
    paged = tm.init_cache(2, 32, kv_pages=9, page_size=8, kv_dtype="int8")
    for c, lead in ((dense, (4, 2, 32)), (paged, (4, 9, 8))):
        assert c.quantized and len(c) == 4
        assert c.k.dtype == c.v.dtype == torch.int8
        assert c.k.shape == lead + (cfg.n_kv_heads, cfg.head_dim)
        assert c.k_scale.dtype == torch.float32 and c.k_scale.shape == lead + (cfg.n_kv_heads,)
    plain = tm.init_cache(2, 32)
    assert not plain.quantized and len(plain) == 2
    with pytest.raises(ValueError, match="kv_cache_dtype"):
        tm.init_cache(2, 32, kv_dtype="fp8")


@pytest.mark.parametrize("arch", ["llada-8b", "dream-7b"])
def test_int8_generate_tokens_match_reference(arch):
    """The JAX engine's int8 es tokens (dense: its own
    tests/test_paged_engine.py holds paged int8 equal to dense int8) equal
    the port's, dense and paged."""
    jm, params, tm = models(arch)
    jgen, tgen = gen_configs(**MODES["es"])
    prompt = prompt_for(tm.cfg)
    want = np.asarray(jmake(jm, jgen, **INT8).generate(params, jnp.asarray(prompt),
                                                       jax.random.PRNGKey(0)))
    assert len(np.unique(want[:, PROMPT_LEN:])) >= 10, "degenerate reference output"
    got = {}
    for name, kw in (("dense", {}), ("paged", dict(paged=True, page_size=PS))):
        eng = tmake(tm, tgen, device="cpu", **INT8, **kw)
        got[name] = eng.generate(torch.from_numpy(prompt)).numpy()
        np.testing.assert_array_equal(got[name], want, err_msg=name)
        assert eng.last_state.cache.quantized
    # and tests/test_engine.py: int8 agrees with the full-precision cache
    full = tmake(tm, tgen, device="cpu").generate(torch.from_numpy(prompt)).numpy()
    agreement = (full == got["dense"]).mean()
    assert agreement > 0.9, f"int8 KV diverged: {agreement}"


def test_sparse_probe_scores_unscaled_codes_in_both_packages():
    """The reference's probe reads ``caches["kv"]["0"].k[g]``: under the int8
    cache that is the codes without their scales.  The port mirrors it: in
    both packages the retained set of an int8 cache equals that of a float
    cache holding the codes, and the two packages agree."""
    jm, params, tm = models("llada-8b", SPARSE_SCALE)
    jgen, tgen = sparse_gens("es_sparse")
    jeng, teng = jmake(jm, jgen), tmake(tm, tgen, device="cpu")
    cfg, rng = tm.cfg, np.random.default_rng(4)
    b, t_total, lb = 2, PROMPT_LEN + tgen.gen_length, tgen.block_length
    shape = (cfg.n_layers, b, t_total, cfg.n_kv_heads, cfg.head_dim)
    k8 = rng.integers(-127, 128, shape).astype(np.int8)
    ks = rng.uniform(0.001, 0.05, shape[:-1]).astype(np.float32)
    hidden = tuple(rng.standard_normal((b, lb, cfg.d_model)).astype(np.float32)
                   for _ in range(teng.n_stages))
    bs = np.array([PROMPT_LEN, PROMPT_LEN + lb], np.int32)
    pstart = np.array([0, 3], np.int32)
    kv_valid = rng.random((b, t_total)) < 0.8
    tokens = np.zeros((b, t_total), np.int32)

    def jkeep(k, scale=None):
        cache = JKVCache(jnp.asarray(k), jnp.asarray(k), *(
            (None, None) if scale is None else (jnp.asarray(scale),) * 2))
        return np.asarray(jeng._sparse_evict(params, {"kv": {"0": cache}},
                                             tuple(map(jnp.asarray, hidden)), jnp.asarray(bs),
                                             jnp.asarray(tokens), jnp.asarray(pstart), None,
                                             jnp.asarray(kv_valid)))

    def tkeep(k, scale=None):
        k = torch.from_numpy(k)
        cache = (KVCache(k, k) if scale is None
                 else QuantKVCache(k, k, *(torch.from_numpy(scale),) * 2))
        return teng._sparse_evict(cache, tuple(map(torch.from_numpy, hidden)),
                                  torch.from_numpy(bs), torch.from_numpy(pstart), None,
                                  torch.from_numpy(kv_valid)).numpy()
    quantized = jkeep(k8, ks)
    np.testing.assert_array_equal(quantized, jkeep(k8.astype(np.float32)))
    assert not np.array_equal(quantized, jkeep(k8 * ks[..., None])), \
        "the scales must change the retained set for this pin to mean anything"
    np.testing.assert_array_equal(tkeep(k8, ks), quantized)
    np.testing.assert_array_equal(tkeep(k8.astype(np.float32)), quantized)


def test_int8_sparse_retained_sets_match_reference():
    """es+sparse under the int8 cache on reduced Dream (GQA: the probe
    repeats a KV head's codes over its query heads): tokens and every
    refresh's retained set equal the JAX engine's, dense and paged."""
    jm, params, tm = models("dream-7b", SPARSE_SCALE)
    jgen, tgen = sparse_gens("es_sparse")
    prompt = prompt_for(tm.cfg, seed=2)
    jeng = jmake(jm, jgen, **INT8)
    jkeeps = _jax_keeps(jeng)
    want = np.asarray(jeng.generate(params, jnp.asarray(prompt), jax.random.PRNGKey(0)))
    for ekw in ({}, dict(paged=True, page_size=PS)):
        teng = tmake(tm, tgen, device="cpu", **INT8, **ekw)
        records = _torch_keeps(teng)
        np.testing.assert_array_equal(teng.generate(torch.from_numpy(prompt)).numpy(), want,
                                      err_msg=str(ekw))
        assert len(records) == len(jkeeps) > 4
        for i, (rec, jk) in enumerate(zip(records, jkeeps)):
            np.testing.assert_array_equal(rec[0].numpy(), jk, err_msg=f"refresh {i} {ekw}")
        assert not records[-1][2].all()


ES1 = dict(mode="es", skip_stages=((1, 0.5),), prompt_refresh_period=8, block_refresh_period=4)


def test_int8_served_with_sharing_matches_reference():
    """Two sampled cohorts (3 and 2 duplicates) and a lone request in one
    cycle under the int8 cache: every follower forks (K/V and scale pools),
    and the tokens and the fork count equal the JAX scheduler's."""
    jm, params, tm = models("llada-8b")
    jgen, tgen = gen_configs(**dict(ES1, temperature=0.8, prompt_refresh_period=4,
                                    block_refresh_period=3))
    rng = np.random.default_rng(2)
    a, b, c = (rng.integers(3, tm.cfg.vocab_size, n).astype(np.int32) for n in (16, 12, 9))
    prompts = [a, a, a, b, b, c]

    def run(sched, make_req):
        reqs = [make_req(prompt=p.copy(), sample_seed=100 + i) for i, p in enumerate(prompts)]
        for r in reqs:
            sched.submit(r)
        sched.drain()
        assert all(r.error is None for r in reqs)
        return [r.output for r in reqs]
    kw = dict(max_slots=6, prompt_len=PROMPT_LEN, paged=True, page_size=PS, prefix_sharing=True,
              **INT8)
    sched = StreamScheduler(tm, tgen, device="cpu", **kw)
    got = run(sched, Request)
    jsched = JScheduler(jm, params, jgen, attn_impl="xla", **kw)
    want = run(jsched, JRequest)
    assert sched.stats.cow_forks == jsched.stats.cow_forks > 0
    assert sched.stats.pages_in_use == 0
    assert len({o.tobytes() for o in got[:3]}) == 3, "the seeds must diverge"
    for i, (x, y) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(x, y, err_msg=f"request {i}")


def test_int8_served_with_preemption_matches_reference():
    """A pool that holds one request: the class-1 arrival spills the class-0
    resident (codes and scales), which resumes; tokens and failure gauges
    equal the JAX scheduler's."""
    jm, params, tm = models("dream-7b")
    jgen, tgen = gen_configs(**ES1, temperature=0.8)
    rng = np.random.default_rng(5)
    prompts = [rng.integers(3, tm.cfg.vocab_size, PROMPT_LEN).astype(np.int32) for _ in "ab"]
    kw = dict(max_slots=2, prompt_len=PROMPT_LEN, paged=True, page_size=PS,
              kv_pages=(PROMPT_LEN + tgen.gen_length) // PS + 1, preemption=True, **INT8)

    def run(sched, make_req):
        low = make_req(prompt=prompts[0].copy(), priority=0, sample_seed=11)
        high = make_req(prompt=prompts[1].copy(), priority=1, sample_seed=22)
        sched.submit(low)
        sched.step()
        sched.submit(high)
        sched.drain()
        assert low.error is None and high.error is None
        return [low.output, high.output], sched.stats
    got, st = run(StreamScheduler(tm, tgen, device="cpu", **kw), Request)
    want, jst = run(JScheduler(jm, params, jgen, attn_impl="xla", **kw), JRequest)
    assert st.preemptions == jst.preemptions >= 1
    assert st.pages_spilled == jst.pages_spilled
    for x, y in zip(got, want):
        np.testing.assert_array_equal(x, y)


def test_int8_page_operations_move_every_plane():
    """fork, spill, scrub and restore act on the codes and the scales."""
    _, _, tm = models("llada-8b")
    eng = tmake(tm, gen_configs(**ES1)[1], device="cpu", paged=True, page_size=PS,
                kv_pages=9, **INT8)
    st = eng.init_engine_state(2, PROMPT_LEN)
    g = torch.Generator().manual_seed(0)
    for plane in st.cache:
        plane.copy_(torch.randint(-127, 128, plane.shape, generator=g).to(plane.dtype))
    eng.fork_pages(st, [1], [2])
    for plane in st.cache:
        assert torch.equal(plane[:, 2], plane[:, 1])
    before = [p.clone() for p in st.cache]
    snap = eng.spill_pages(st, [3, 4])
    assert len(snap) == 4 and snap[2].shape == (4, 2, PS, tm.cfg.n_kv_heads)
    eng.scrub_pages(st, [3, 4])
    assert all(not p[:, 3:5].any() for p in st.cache)
    eng.restore_pages(st, [3, 4], snap)
    for p, q in zip(st.cache, before):
        assert torch.equal(p, q)
    eng.scrub_pages(st, [3])
    eng.restore_pages(st, [5, 6], snap)
    for p, q in zip(st.cache, before):
        assert torch.equal(p[:, 5:7], q[:, 3:5])
