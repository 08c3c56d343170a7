"""The port's kernel functions against the JAX reference's.

On the CPU the port's ops run their plain PyTorch versions; the reference
runs its Pallas kernels in interpret mode (``impl="pallas"``) and its XLA
lowering.  The same numpy inputs go through both.  The hand-written CUDA
kernels are held against the plain versions by the ``cuda``-marked test,
which needs a card.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import build, ops, ref
from repro_torch.kernels.flash_attention import flash_attention, paged_flash_attention, plan
from repro_torch.kernels.importance import importance, variation
from repro_torch.kernels.scatter_kv import fork_pages, scatter_rows, scatter_rows_paged
from repro_torch.kernels.scatter_kv import plan as scatter_plan
from repro_torch.kernels.ssd_scan import plan as ssd_plan
from repro_torch.kernels.ssd_scan import ssd_chunks

ATOL = 2e-5   # f32: the two sides sum the softmax in different orders


def _attn_inputs(seed, b, hq, hkv, lq, lkv, d=32):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, hq, lq, d), np.float32)
    k = rng.standard_normal((b, hkv, lkv, d), np.float32)
    v = rng.standard_normal((b, hkv, lkv, d), np.float32)
    q_pos = np.tile(np.arange(lkv - lq, lkv, dtype=np.int32), (b, 1))
    kv_pos = np.tile(np.arange(lkv, dtype=np.int32), (b, 1))
    return q, k, v, q_pos, kv_pos


# (name, Hq, Hkv, Lq, mask kwargs, edit): T = 40 positions, block Lb = 8,
# keep_k = 4 after a skip stage, prompt of 24 (block-causal bc_start)
ATTN_CASES = [
    ("mha_block", 4, 4, 8, {}, None),
    ("mha_keep_k", 4, 4, 4, {}, None),
    ("mha_full_T", 4, 4, 40, {}, None),
    ("gqa_block", 4, 2, 8, {}, None),
    ("gqa_full_T", 4, 1, 40, {}, None),
    ("gqa_invalid_rows", 4, 2, 8, {}, "kv_invalid"),
    ("causal", 4, 2, 40, {"causal": True}, None),
    ("window_anchor", 4, 2, 40, {"window": 6, "anchor": 5}, None),
    ("block_causal", 4, 2, 40, {"bc_start": 24, "bc_block": 8}, "kv_invalid"),
    ("fully_masked_row", 4, 2, 8, {"causal": True}, "masked_row"),
]


@pytest.mark.parametrize("case", ATTN_CASES, ids=[c[0] for c in ATTN_CASES])
@pytest.mark.parametrize("impl", ["pallas", "xla"])
def test_attention_matches_reference(case, impl):
    name, hq, hkv, lq, kw, edit = case
    q, k, v, q_pos, kv_pos = _attn_inputs(len(name), 2, hq, hkv, lq, 40)
    if edit == "kv_invalid":
        kv_pos[:, 3:6] = -1
        kv_pos[1, 30:] = -1
    if edit == "masked_row":
        q_pos[0, 2] = -1          # causal: no key has kv_pos <= -1
    want = jops.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(q_pos),
                          jnp.asarray(kv_pos), impl=impl, block_q=8, block_kv=128, **kw)
    got = ops.attention(*(torch.from_numpy(a) for a in (q, k, v, q_pos, kv_pos)), **kw)
    assert got.shape == (2, hq, lq, 32) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)
    if edit == "masked_row":
        assert np.all(got.numpy()[0, :, 2] == 0.0)


def test_attention_mask_rule():
    """Spot values of the position rule: kv_pos < 0, causal, window+anchor,
    block-causal (prompt rows are block -1)."""
    q_pos = torch.tensor([[10, 30]])
    kv_pos = torch.tensor([[-1, 2, 9, 11, 25, 31]])
    m = ref.attention_mask(q_pos, kv_pos)
    assert m[0].tolist() == [[False, True, True, True, True, True]] * 2
    m = ref.attention_mask(q_pos, kv_pos, causal=True)
    assert m[0].tolist() == [[False, True, True, False, False, False],
                             [False, True, True, True, True, False]]
    m = ref.attention_mask(q_pos, kv_pos, window=2, anchor=3)
    assert m[0].tolist() == [[False, True, True, True, False, False],
                             [False, True, False, False, False, True]]
    m = ref.attention_mask(q_pos, kv_pos, bc_start=20, bc_block=8)
    assert m[0].tolist() == [[False, True, True, True, False, False],
                             [False, True, True, True, True, True]]


@pytest.mark.parametrize("shape", [(2, 32, 4, 16), (1, 64, 1, 128), (3, 17, 2, 8)])
@pytest.mark.parametrize("impl", ["pallas", "xla"])
def test_scatter_rows_matches_reference(shape, impl):
    b, s, h, d = shape
    k = min(5, s)
    rng = np.random.default_rng(s)
    cache = rng.standard_normal(shape, np.float32)
    new = rng.standard_normal((b, k, h, d), np.float32)
    idx = np.stack([rng.permutation(s)[:k] for _ in range(b)]).astype(np.int32)
    want = np.asarray(jops.scatter_rows(jnp.asarray(cache), jnp.asarray(new),
                                        jnp.asarray(idx), impl=impl))
    got = torch.from_numpy(cache.copy())
    ops.scatter_rows(((got, torch.from_numpy(new)),), torch.from_numpy(idx))   # in place
    np.testing.assert_array_equal(got.numpy(), want)
    untouched = np.ones((b, s), bool)
    for i in range(b):
        untouched[i, idx[i]] = False
    np.testing.assert_array_equal(got.numpy()[untouched], cache[untouched])


def test_scatter_kv_pair_equals_two_scatters():
    rng = np.random.default_rng(3)
    kc, vc = (torch.from_numpy(rng.standard_normal((2, 12, 2, 8), np.float32)) for _ in "kv")
    kn, vn = (torch.from_numpy(rng.standard_normal((2, 4, 2, 8), np.float32)) for _ in "kv")
    idx = torch.tensor([[0, 5, 7, 11], [3, 2, 1, 9]], dtype=torch.int32)
    want_k, want_v = kc.clone(), vc.clone()
    ops.scatter_rows(((want_k, kn),), idx)
    ops.scatter_rows(((want_v, vn),), idx)
    ops.scatter_rows(((kc, kn), (vc, vn)), idx)
    assert torch.equal(kc, want_k) and torch.equal(vc, want_v)


@pytest.mark.parametrize("impl", ["pallas", "xla"])
@pytest.mark.parametrize("alpha", [0.0, 0.5, 1.0])
def test_importance_matches_reference(impl, alpha):
    rng = np.random.default_rng(int(alpha * 10))
    hn = rng.standard_normal((3, 16, 64), np.float32)
    ho = rng.standard_normal((3, 16, 64), np.float32)
    conf = rng.uniform(size=(3, 16)).astype(np.float32)
    want = np.asarray(jops.importance_score(jnp.asarray(hn), jnp.asarray(ho), jnp.asarray(conf),
                                            alpha=alpha, impl=impl))
    got = ops.importance_score(torch.from_numpy(hn), torch.from_numpy(ho),
                               torch.from_numpy(conf), alpha=alpha)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)


def test_wrappers_refuse_cpu_tensors():
    """A wrapper launches its kernel or raises: it never computes on the CPU."""
    x = torch.zeros(1, 2, 4, 8)
    pos = torch.zeros(1, 4, dtype=torch.int32)
    bt = torch.zeros(1, 1, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention(x, x, x, pos, pos)
    with pytest.raises(ValueError, match="CUDA"):
        paged_flash_attention(x, torch.zeros(2, 4, 2, 8), torch.zeros(2, 4, 2, 8), pos, pos, bt)
    with pytest.raises(ValueError, match="CUDA"):
        scatter_rows(((torch.zeros(1, 4, 8), torch.zeros(1, 2, 8)),),
                     torch.zeros(1, 2, dtype=torch.int32))
    with pytest.raises(ValueError, match="CUDA"):
        scatter_rows_paged(((torch.zeros(2, 4, 8), torch.zeros(1, 2, 8)),),
                           torch.zeros(1, 2, dtype=torch.int32), bt)
    for fn in (importance, variation):
        with pytest.raises(ValueError, match="CUDA"):
            fn(torch.zeros(1, 2, 8), torch.zeros(1, 2, 8), torch.zeros(1, 2), alpha=0.5)


def test_ops_refuse_mixed_devices():
    meta = torch.zeros(1, 2, 8, device="meta")
    with pytest.raises(ValueError, match="one CUDA device or the CPU"):
        ops.importance_score(meta, torch.zeros(1, 2, 8), torch.zeros(1, 2), alpha=0.5)


def test_library_is_keyed_by_sources():
    """The built library's name hashes every source in csrc/ and the flags."""
    path = build.library_path()
    assert path.parent == build.BUILD_DIR and path.suffix == ".so"
    assert path == build.library_path()
    assert set(build.SOURCES) <= {p.name for p in build.CSRC.iterdir()}


# ---------------------------------------------------------------------------
# serving kernels: paged attention, paged and masked scatter, variation
# ---------------------------------------------------------------------------
def _paged_layout(seed, page_size, b=3, n_vp=5, num_pages=17):
    """Block tables over a shuffled physical page order with some unmapped
    pages (row 2 has none mapped), and kv_pos with a left-pad prompt start."""
    rng = np.random.default_rng(seed)
    perm = rng.permutation(np.arange(1, num_pages))[: b * n_vp].astype(np.int32)
    bt = perm.reshape(b, n_vp)
    bt[0, 0] = -1
    bt[1, 3:] = -1
    bt[2, :] = -1
    t_total = n_vp * page_size
    pos = np.tile(np.arange(t_total, dtype=np.int32), (b, 1))
    kv_pos = np.where(pos >= np.array([[3], [page_size + 2], [0]]), pos, -1).astype(np.int32)
    return rng, bt, kv_pos, t_total


@pytest.mark.parametrize("page_size", [8, 16])
@pytest.mark.parametrize("hq,hkv", [(4, 4), (4, 2)], ids=["mha", "gqa"])
@pytest.mark.parametrize("impl", ["pallas", "xla"])
def test_paged_attention_matches_reference(page_size, hq, hkv, impl):
    rng, bt, kv_pos, t_total = _paged_layout(page_size + hkv, page_size)
    pool_k, pool_v = (rng.standard_normal((17, page_size, hkv, 32), np.float32) for _ in "kv")
    q = rng.standard_normal((3, hq, 8, 32), np.float32)
    q_pos = rng.integers(0, t_total, (3, 8)).astype(np.int32)
    want = np.asarray(jops.paged_attention(
        *(jnp.asarray(a) for a in (q, pool_k, pool_v, q_pos, kv_pos, bt)),
        page_size=page_size, impl=impl))
    got = ops.paged_attention(*(torch.from_numpy(a) for a in (q, pool_k, pool_v, q_pos,
                                                              kv_pos, bt)))
    assert got.shape == (3, hq, 8, 32) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)
    assert np.all(got.numpy()[2] == 0.0)       # nothing mapped: every row writes 0


MASKS = [(None, None), ("row", None), (None, "token"), ("row", "token")]


def _masks(rng, b, k, which):
    row = (np.arange(b) % 2 == 0) if which[0] else None
    tok = np.tile(np.arange(k) % 2 == 0, (b, 1)) if which[1] else None
    return row, tok


@pytest.mark.parametrize("page_size", [8, 16])
@pytest.mark.parametrize("which", MASKS, ids=["plain", "row", "token", "row+token"])
@pytest.mark.parametrize("impl", ["pallas", "xla"])
def test_paged_scatter_matches_reference(page_size, which, impl):
    """Bit-exact on every real page.  Page 0 is the garbage page: the
    reference also writes masked rows there, the port does not write them;
    it is never read unmasked."""
    rng, bt, _, t_total = _paged_layout(page_size, page_size)
    pool = rng.standard_normal((17, page_size, 2, 16), np.float32)
    new = rng.standard_normal((3, 6, 2, 16), np.float32)
    idx = np.stack([rng.permutation(t_total)[:6] for _ in range(3)]).astype(np.int32)
    mapped = 2 * page_size + 1                  # on row 0's mapped page 2: written in every case
    idx[0] = [mapped] + [i for i in idx[0] if i != mapped][:5]
    row, tok = _masks(rng, 3, 6, which)
    want = np.asarray(jops.scatter_rows_paged(
        jnp.asarray(pool), jnp.asarray(new), jnp.asarray(idx), jnp.asarray(bt),
        page_size=page_size, impl=impl,
        row_mask=None if row is None else jnp.asarray(row),
        token_mask=None if tok is None else jnp.asarray(tok)))
    got = torch.from_numpy(pool.copy())
    ops.scatter_rows_paged(((got, torch.from_numpy(new)),), torch.from_numpy(idx),
                           torch.from_numpy(bt),
                           row_mask=None if row is None else torch.from_numpy(row),
                           token_mask=None if tok is None else torch.from_numpy(tok))
    np.testing.assert_array_equal(got.numpy()[1:], want[1:])
    assert not np.array_equal(want[1:], pool[1:]), "the case wrote nothing"


@pytest.mark.parametrize("which", MASKS[1:], ids=["row", "token", "row+token"])
@pytest.mark.parametrize("impl", ["pallas", "xla"])
def test_masked_scatter_matches_reference(which, impl):
    rng = np.random.default_rng(len(which[0] or "") + len(which[1] or ""))
    cache = rng.standard_normal((3, 20, 2, 16), np.float32)
    new = rng.standard_normal((3, 5, 2, 16), np.float32)
    idx = np.stack([rng.permutation(20)[:5] for _ in range(3)]).astype(np.int32)
    row, tok = _masks(rng, 3, 5, which)
    want = np.asarray(jops.scatter_rows(
        jnp.asarray(cache), jnp.asarray(new), jnp.asarray(idx), impl=impl,
        row_mask=None if row is None else jnp.asarray(row),
        token_mask=None if tok is None else jnp.asarray(tok)))
    got = torch.from_numpy(cache.copy())
    ops.scatter_rows(((got, torch.from_numpy(new)),), torch.from_numpy(idx),
                     row_mask=None if row is None else torch.from_numpy(row),
                     token_mask=None if tok is None else torch.from_numpy(tok))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("impl", ["pallas", "xla"])
@pytest.mark.parametrize("alpha", [0.0, 0.5])
def test_variation_matches_reference(impl, alpha):
    rng = np.random.default_rng(int(alpha * 10) + 7)
    hn = rng.standard_normal((3, 24, 64), np.float32)
    ho = rng.standard_normal((3, 24, 64), np.float32)
    ho[1, 5] = 0.0                              # a cold (never observed) cached row
    conf = rng.uniform(size=(3, 24)).astype(np.float32)
    want = np.asarray(jops.variation_score(jnp.asarray(hn), jnp.asarray(ho), jnp.asarray(conf),
                                           alpha=alpha, impl=impl))
    got = ops.variation_score(torch.from_numpy(hn), torch.from_numpy(ho),
                              torch.from_numpy(conf), alpha=alpha)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0)
    assert got[1, 5].item() == pytest.approx(alpha * conf[1, 5] + (1 - alpha), rel=1e-6)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_kernels_match_plain_versions(cuda_device, dtype):
    g = torch.Generator(device=cuda_device).manual_seed(0)
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    # pad > 0: rows of a wider buffer, so the strides are not 16-byte multiples;
    # with D 80 or 96, or such strides, K/V are staged element by element
    for hq, hkv, lq, d, pad, kw in ((4, 4, 8, 32, 0, {}), (28, 4, 32, 128, 0, {"causal": True}),
                                    (4, 2, 40, 64, 0, {"window": 6, "anchor": 5}),
                                    (4, 2, 5, 128, 0, {"bc_start": 24, "bc_block": 8}),
                                    (4, 2, 8, 80, 0, {}), (28, 4, 16, 96, 0, {"causal": True}),
                                    (4, 2, 8, 64, 2, {"window": 6, "anchor": 5})):
        def rows(n, h):
            x = torch.randn(2, n, h, d + pad, generator=g, device=cuda_device).to(dtype)
            return x[..., :d].transpose(1, 2)
        q, k, v = rows(lq, hq), rows(40, hkv), rows(40, hkv)
        q_pos = torch.arange(40 - lq, 40, dtype=torch.int32, device=cuda_device).repeat(2, 1)
        kv_pos = torch.arange(40, dtype=torch.int32, device=cuda_device).repeat(2, 1)
        kv_pos[1, 3:9] = -1
        got = flash_attention(q, k, v, q_pos, kv_pos, **kw)
        want = ref.attention_reference(q, k, v, q_pos, kv_pos, **kw)
        assert (got.float() - want.float()).abs().max().item() <= tol
    # split-KV on the tensor-core body: one batch entry, 1580 KV rows in
    # splits of whole tiles (the last ragged), split 0 fully masked, and a
    # query row with nothing valid; MHA (8 heads: 3 splits) and Dream's 28/4
    # GQA (2 splits)
    for hq, hkv in ((8, 8), (28, 4)):
        q = torch.randn(1, 32, hq, 128, generator=g, device=cuda_device).to(dtype).transpose(1, 2)
        k, v = (torch.randn(1, 1580, hkv, 128, generator=g, device=cuda_device).to(dtype)
                .transpose(1, 2) for _ in "kv")
        q_pos = torch.arange(1548, 1580, dtype=torch.int32, device=cuda_device)[None].contiguous()
        kv_pos = torch.arange(1580, dtype=torch.int32, device=cuda_device)[None].contiguous()
        kv_pos[:, :832] = -1
        q_pos[0, 3] = -1
        pl = plan(q, k, v, 1580, hkv)
        assert pl.body == ("tensor_core" if dtype == torch.bfloat16 else "cuda_core")
        assert pl.body == "cuda_core" or (
            pl.n_splits >= 2 and ref.split_bounds(1580, pl.n_splits)[0][1] <= 832)
        for _ in range(2):                          # the merge counters are left at 0
            got = flash_attention(q, k, v, q_pos, kv_pos, causal=True)
            want = ref.attention_reference(q, k, v, q_pos, kv_pos, causal=True)
            assert (got.float() - want.float()).abs().max().item() <= tol
            assert got[0, :, 3].abs().max().item() == 0.0
    # the dense scatter: a small row; Dream's 4 KV heads of 128 (1 KB rows in
    # bf16) under the serving masks; LLaDA's skip stage 2 (8 tokens of 32
    # heads); 8 tokens of rows past 16 KB (80 heads), which the planner cuts
    # across blocks
    for h, d, kk, masked in ((4, 32, 6, False), (4, 128, 32, True), (32, 128, 8, False),
                             (80, 128, 8, False)):
        cache = torch.randn(2, 40, h, d, generator=g, device=cuda_device).to(dtype)
        new = torch.randn(2, kk, h, d, generator=g, device=cuda_device).to(dtype)
        idx = torch.stack([torch.randperm(40, generator=g, device=cuda_device)[:kk]
                           for _ in range(2)]).to(torch.int32)
        mk = {}
        if masked:
            mk = dict(row_mask=torch.tensor([True, False], device=cuda_device),
                      token_mask=torch.rand(2, kk, generator=g, device=cuda_device) < 0.5)
        want = ref.scatter_rows_reference(cache.clone(), new, idx, **mk)
        row_bytes = h * d * cache.element_size()
        assert (scatter_plan(2, kk, 1, row_bytes).chunk_bytes < row_bytes) == (h == 80)
        got = cache.clone()
        scatter_rows(((got, new),), idx, **mk)
        assert torch.equal(got, want)
    # the C entry points launch on PyTorch's current stream, also inside a
    # torch.cuda.stream block
    dev = cache.device
    assert build.stream_ptr(dev) == torch.cuda.current_stream(dev).cuda_stream
    side = torch.cuda.Stream(dev)
    with torch.cuda.stream(side):
        assert build.stream_ptr(dev) == side.cuda_stream
        assert build.stream_ptr(dev) != torch.cuda.default_stream(dev).cuda_stream
    assert build.stream_ptr(dev) == torch.cuda.default_stream(dev).cuda_stream
    with pytest.raises(ValueError, match="16 bytes"):     # rows of 9 elements
        scatter_rows(((got[:, :, :3, :3].contiguous(), new[:, :, :3, :3].contiguous()),), idx)
    with pytest.raises(ValueError, match="token_mask must be contiguous"):
        scatter_rows(((got, new),), idx, token_mask=torch.ones(kk, 2, dtype=torch.bool,
                                                               device=cuda_device).t())
    with pytest.raises(ValueError, match="row_mask must be contiguous torch.bool"):
        scatter_rows(((got, new),), idx, row_mask=torch.ones(2, device=cuda_device))
    hn = torch.randn(2, 8, 4096, generator=g, device=cuda_device).to(dtype)
    ho = torch.randn(2, 8, 4096, generator=g, device=cuda_device).to(dtype)
    conf = torch.rand(2, 8, generator=g, device=cuda_device)
    got = importance(hn, ho, conf, alpha=0.5)
    want = ref.importance_reference(hn, ho, conf, 0.5)
    assert ((got - want).abs() / want.abs()).max().item() <= 1e-5
    ho[0, 3] = 0.0
    got = variation(hn, ho, conf, alpha=0.5)
    want = ref.variation_reference(hn, ho, conf, 0.5)
    assert ((got - want).abs() / want.abs()).max().item() <= 1e-5
    assert abs(got[0, 3].item() - (0.5 * conf[0, 3].item() + 0.5)) <= 1e-6
    # the skip stage's scoring through idx (repeated rows included), at
    # Dream's width, a ragged width (rows off 16-byte boundaries: scalar head
    # and tail) and a width whose rows start unaligned in a wider buffer
    for d, pad in ((3584, 0), (1001, 0), (64, 3)):
        hn = torch.randn(2, 16, d, generator=g, device=cuda_device).to(dtype)
        buf = torch.randn(2 * 32 * d + pad, generator=g, device=cuda_device).to(dtype)
        ho = buf[pad:].view(2, 32, d)
        conf = torch.rand(2, 32, generator=g, device=cuda_device)
        idx = torch.randint(0, 32, (2, 16), generator=g, device=cuda_device).int()
        idx[1, :4] = idx[1, 4]
        ho[0, idx[0, 2]] = 0.0                  # a zero cached row
        before = importance.launches
        got = importance(hn, ho, conf, alpha=0.5, idx=idx)
        assert importance.launches == before + 1
        want = ref.importance_reference(hn, ho, conf, 0.5, idx=idx)
        assert ((got - want).abs() / want.abs()).max().item() <= 1e-5, d
        got = variation(hn, ho[:, :16].contiguous(), conf[:, :16].contiguous(), alpha=0.5)
        want = ref.variation_reference(hn, ho[:, :16], conf[:, :16], 0.5)
        assert ((got - want).abs() / want.abs()).max().item() <= 1e-5, d
    # an index outside [0, S) reads nothing and scores NaN; the others stand
    idx[0, 5], idx[1, 0] = 32, -1
    got = importance(hn, ho, conf, alpha=0.5, idx=idx)
    want = ref.importance_reference(hn, ho, conf, 0.5, idx=idx.clamp(0, 31))
    bad = torch.zeros_like(got, dtype=torch.bool)
    bad[0, 5] = bad[1, 0] = True
    assert got[bad].isnan().all().item() and not got[~bad].isnan().any().item()
    assert ((got - want).abs() / want.abs())[~bad].max().item() <= 1e-5
    for ps in (8, 16):
        bt = torch.randperm(15, generator=g, device=cuda_device)[:10].add(1).int().view(2, 5)
        bt[0, 1] = -1
        pool_k = torch.randn(16, ps, 2, 64, generator=g, device=cuda_device).to(dtype)
        pool_v = torch.randn(16, ps, 2, 64, generator=g, device=cuda_device).to(dtype)
        q = torch.randn(2, 4, 8, 64, generator=g, device=cuda_device).to(dtype)
        q_pos = torch.arange(8, dtype=torch.int32, device=cuda_device).repeat(2, 1)
        kv_pos = torch.arange(5 * ps, dtype=torch.int32, device=cuda_device).repeat(2, 1)
        got = paged_flash_attention(q, pool_k, pool_v, q_pos, kv_pos, bt)
        want = ref.paged_attention_reference(q, pool_k, pool_v, q_pos, kv_pos, bt)
        assert (got.float() - want.float()).abs().max().item() <= tol
        # one Dream slot (28/4 GQA) over 1600 virtual rows in two splits at
        # row 832: split 0 on unmapped pages only, split 1 ragged
        n_vp = 1600 // ps
        gbt = (torch.randperm(n_vp, generator=g, device=cuda_device) + 1).int().view(1, n_vp)
        gbt[0, : 832 // ps] = -1
        gk, gv = (torch.randn(n_vp + 1, ps, 4, 128, generator=g,
                              device=cuda_device).to(dtype) for _ in "kv")
        q = torch.randn(1, 28, 32, 128, generator=g, device=cuda_device).to(dtype)
        gq_pos = torch.arange(1568, 1600, dtype=torch.int32, device=cuda_device)[None].contiguous()
        gkv_pos = torch.arange(1600, dtype=torch.int32, device=cuda_device)[None].contiguous()
        gkv_pos[0, 1500:] = -1
        pl = plan(q, gk, gv, 1600, 4, ps)
        assert pl.body == "cuda_core" or ref.split_bounds(1600, pl.n_splits)[0] == (0, 832)
        got = paged_flash_attention(q, gk, gv, gq_pos, gkv_pos, gbt)
        want = ref.paged_attention_reference(q, gk, gv, gq_pos, gkv_pos, gbt)
        assert (got.float() - want.float()).abs().max().item() <= tol
        new = torch.randn(2, 6, 2, 64, generator=g, device=cuda_device).to(dtype)
        idx = torch.stack([torch.randperm(5 * ps, generator=g, device=cuda_device)[:6]
                           for _ in range(2)]).int()
        mk = dict(row_mask=torch.tensor([True, False], device=cuda_device),
                  token_mask=torch.rand(2, 6, generator=g, device=cuda_device) < 0.5)
        for masks in ({}, {"row_mask": mk["row_mask"]}, {"token_mask": mk["token_mask"]}, mk):
            got = pool_k.clone()
            scatter_rows_paged(((got, new),), idx, bt, **masks)
            want = ref.scatter_rows_paged_reference(pool_k.clone(), new, idx, bt, **masks)
            assert torch.equal(got[1:], want[1:])
        with pytest.raises(ValueError, match="token_mask must be contiguous torch.bool"):
            scatter_rows_paged(((got, new),), idx, bt, token_mask=mk["token_mask"].int())
    # the copy-on-write fork: in place, (0, 0) pads, aliased lists refused
    pools = [torch.randn(3, 16, 8, 2, 64, generator=g, device=cuda_device).to(dtype)
             for _ in "kv"]
    src, dst = [4, 0, 9, 0, 2, 0, 0, 0], [11, 0, 5, 0, 13, 0, 0, 0]
    want = [ref.fork_pages_reference(p.clone(), torch.tensor(src), torch.tensor(dst))
            for p in (t.cpu() for t in pools)]
    ptrs = [p.data_ptr() for p in pools]
    fork_pages(*pools, src, dst)
    assert [p.data_ptr() for p in pools] == ptrs
    assert all(torch.equal(p.cpu(), w) for p, w in zip(pools, want))
    with pytest.raises(ValueError, match="also sources"):
        fork_pages(*pools, [4, 11], [11, 12])
    # the SSD chunk step, B and C strided views of one projection as in the
    # mixer: one chunk of 32 (the decode block), three chunks of 64 (the
    # prefill), and two groups over three chunks of 16 (N 8: the CUDA-core
    # body).  y_intra is rounded to the dtype once; the rest is f32.  bf16 at
    # N 128 takes the tensor-core body, f32 the CUDA-core body.
    for b, l, h, p, grp, n, ck in ((2, 32, 4, 64, 1, 128, 32), (2, 192, 8, 64, 1, 128, 64),
                                   (2, 48, 4, 16, 2, 8, 16)):
        x = (torch.randn(b, l, h, p, generator=g, device=cuda_device) * 0.5).to(dtype)
        dt = torch.nn.functional.softplus(torch.randn(b, l, h, generator=g, device=cuda_device))
        a_log = torch.randn(h, generator=g, device=cuda_device) * 0.3
        bc = (torch.randn(b, l, 2 * grp * n, generator=g, device=cuda_device) * 0.5).to(dtype)
        bm, cm = (t.reshape(b, l, grp, n) for t in (bc[..., :grp * n], bc[..., grp * n:]))
        body = "tensor_core" if dtype == torch.bfloat16 and n == 128 else "cuda_core"
        assert ssd_plan(x, bm, ck, cm).body == body
        before = getattr(ssd_chunks, f"{body}_launches")
        got = ssd_chunks(x, dt, a_log, bm, cm, chunk=ck)
        assert getattr(ssd_chunks, f"{body}_launches") == before + 1
        want = ref.ssd_chunks(x, dt, a_log, bm, cm, ck)
        for i, (gt, wt) in enumerate(zip(got, want)):
            assert gt.dtype == wt.dtype and gt.shape == wt.shape
            t = 2e-2 if (i == 0 and dtype == torch.bfloat16) else 1e-4
            torch.testing.assert_close(gt.float(), wt.float(), atol=t, rtol=t)
    with pytest.raises(ValueError, match="multiple of chunk"):
        ssd_chunks(x, dt, a_log, bm, cm, chunk=32)


PAGED_OPTIONS = [dict(bc_start=1536, bc_block=32), dict(window=96, anchor=0),
                 dict(window=96, anchor=64), dict(window=96, anchor=64, bc_start=1536, bc_block=32),
                 dict(causal=True)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_paged_mask_options_match_plain_version(cuda_device, dtype):
    """The paged kernel with each mask option, on shuffled pages with some
    unmapped, MHA and Dream's 28/4 GQA (whose packed rows take their key
    block from their own query position), and under the sliding window's
    read table, whose last splits hold no mapped page at all: such a split
    must weigh 0 in the merge."""
    from repro_torch.kernels.flash_attention import window_block_tables
    g = torch.Generator(device=cuda_device).manual_seed(1)
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    for ps in (8, 16):
        for hq, hkv, lq, d in ((4, 4, 8, 64), (28, 4, 32, 128)):
            n_vp = 1600 // ps
            bt = (torch.randperm(n_vp, generator=g, device=cuda_device) + 1).int().view(1, n_vp)
            bt[0, 3] = -1
            pools = [torch.randn(n_vp + 1, ps, hkv, d, generator=g,
                                 device=cuda_device).to(dtype) for _ in "kv"]
            q = torch.randn(1, hq, lq, d, generator=g, device=cuda_device).to(dtype)
            kv_pos = torch.arange(1600, dtype=torch.int32, device=cuda_device)[None].contiguous()
            kv_pos[0, :5] = -1                      # left-pad prompt rows
            for opts in PAGED_OPTIONS:
                q_pos = torch.arange(1600 - 2 * lq, 1600 - lq, dtype=torch.int32,
                                     device=cuda_device)[None].contiguous()
                got = paged_flash_attention(q, *pools, q_pos, kv_pos, bt, **opts)
                want = ref.paged_attention_reference(q, *pools, q_pos, kv_pos, bt, **opts)
                assert (got.float() - want.float()).abs().max().item() <= tol, (ps, hq, opts)
            # the window: rows past the horizon masked, their pages unwalked
            limit = torch.tensor([800], dtype=torch.int32, device=cuda_device)
            read_bt = window_block_tables(bt, limit, ps)
            wkv = ops.window_kv_clamp(kv_pos, limit)
            q_pos = torch.arange(800 - lq, 800, dtype=torch.int32, device=cuda_device)[None]
            pl = plan(q, *pools, 1600, hkv, ps)
            if pl.body == "tensor_core":
                starts = [s for s, _ in ref.split_bounds(1600, pl.n_splits)]
                assert pl.n_splits >= 2 and starts[-1] >= 800, "no split left unmapped"
            for opts in ({}, dict(bc_start=768, bc_block=32)):
                before = paged_flash_attention.tensor_core_launches
                got = paged_flash_attention(q, *pools, q_pos.contiguous(), wkv, read_bt, **opts)
                want = ref.paged_attention_reference(q, *pools, q_pos, wkv, read_bt, **opts)
                assert torch.isfinite(got.float()).all()
                assert (got.float() - want.float()).abs().max().item() <= tol, (ps, hq, opts)
                if dtype == torch.bfloat16:
                    assert paged_flash_attention.tensor_core_launches == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_int8_kernels_match_plain_versions(cuda_device, dtype):
    """The int8 cache's kernels on the card: attention on int8 codes with
    their scales, dense and paged, with mask options (bf16 q on the
    tensor-core body, f32 on the CUDA-core body) within tolerance of the
    plain version; the quantizing scatter, dense and paged under the
    serving masks, bit-equal to it (page 0 aside)."""
    from repro_torch.kernels.scatter_kv import (
        quantize_scatter_rows,
        quantize_scatter_rows_paged,
    )
    g = torch.Generator(device=cuda_device).manual_seed(1)
    tol = 1e-4 if dtype == torch.float32 else 2e-2

    def codes(*shape):
        return ref.quantize_rows(torch.randn(*shape, generator=g, device=cuda_device))
    for hq, hkv, lq, d, kw in ((4, 4, 8, 32, {}), (28, 4, 32, 128, {"causal": True}),
                               (4, 2, 8, 128, {"bc_start": 24, "bc_block": 8, "window": 9})):
        q = torch.randn(2, lq, hq, d, generator=g, device=cuda_device).to(dtype).transpose(1, 2)
        (k8, ks), (v8, vs) = codes(2, 40, hkv, d), codes(2, 40, hkv, d)
        sc = dict(k_scale=ks.transpose(1, 2), v_scale=vs.transpose(1, 2))
        q_pos = torch.arange(40 - lq, 40, dtype=torch.int32, device=cuda_device).repeat(2, 1)
        kv_pos = torch.arange(40, dtype=torch.int32, device=cuda_device).repeat(2, 1)
        kv_pos[1, 3:9] = -1
        assert plan(q, k8.transpose(1, 2), v8.transpose(1, 2), 40, hkv).body == (
            "tensor_core" if dtype == torch.bfloat16 else "cuda_core")
        got = flash_attention(q, k8.transpose(1, 2), v8.transpose(1, 2), q_pos, kv_pos, **sc, **kw)
        want = ref.attention_reference(q, k8.transpose(1, 2), v8.transpose(1, 2), q_pos, kv_pos,
                                       **sc, **kw)
        assert (got.float() - want.float()).abs().max().item() <= tol
        (kp, kps), (vp, vps) = codes(11, 8, hkv, d), codes(11, 8, hkv, d)
        bt = (torch.randperm(10, generator=g, device=cuda_device) + 1).int().view(2, 5)
        bt[0, 1] = -1
        args = (q, kp, vp, q_pos, kv_pos, bt)
        got = paged_flash_attention(*args, k_scale=kps, v_scale=vps, **kw)
        want = ref.paged_attention_reference(*args, k_scale=kps, v_scale=vps, **kw)
        assert (got.float() - want.float()).abs().max().item() <= tol
    for paged, h, d in ((False, 4, 32), (True, 32, 128), (True, 1, 32)):
        lead = (11, 8) if paged else (2, 40)
        planes = [torch.randint(-127, 128, (*lead, h, d), generator=g,
                                device=cuda_device).to(torch.int8) for _ in "kv"]
        scales = [torch.rand(*lead, h, generator=g, device=cuda_device) for _ in "kv"]
        new = [torch.randn(2, 6, h, d, generator=g, device=cuda_device).to(dtype) for _ in "kv"]
        idx = torch.stack([torch.randperm(40, generator=g, device=cuda_device)[:6]
                           for _ in range(2)]).to(torch.int32)
        mk = dict(row_mask=torch.tensor([True, False], device=cuda_device),
                  token_mask=torch.rand(2, 6, generator=g, device=cuda_device) < 0.7)
        bt = (torch.randperm(10, generator=g, device=cuda_device) + 1).int().view(2, 5)
        want = [t.clone() for t in planes + scales]
        got = [t.clone() for t in planes + scales]
        pairs = (((got[0], got[2]), new[0]), ((got[1], got[3]), new[1]))
        if paged:
            for i in range(2):
                ref.quantize_scatter_rows_paged_reference(want[i], want[i + 2], new[i], idx, bt,
                                                          **mk)
            quantize_scatter_rows_paged(pairs, idx, bt, **mk)
        else:
            for i in range(2):
                ref.quantize_scatter_rows_reference(want[i], want[i + 2], new[i], idx, **mk)
            quantize_scatter_rows(pairs, idx, **mk)
        cut = 1 if paged else 0
        assert all(torch.equal(a[cut:], b[cut:]) for a, b in zip(got, want))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_head_dim_256_matches_plain_versions(cuda_device, dtype):
    """Gemma-3's head_dim 256 (4 query heads on 1 KV head) in both bodies:
    kernels 1 and 2 on bf16/f32 K/V and on int8 codes, with the local
    window 512 and without, a dense cache of 704 rows and a split one of
    4096, and the paged pool through a shuffled block table.  Before the
    D = 256 instantiations the dispatchers ran the 128 body on these rows.
    Then the quantizing scatter at 256-element heads (8 elements a thread),
    dense and paged, bit-equal to its plain version."""
    from repro_torch.kernels.scatter_kv import (
        quantize_scatter_rows,
        quantize_scatter_rows_paged,
    )
    g = torch.Generator(device=cuda_device).manual_seed(2)
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    body = "tensor_core" if dtype == torch.bfloat16 else "cuda_core"
    hq, hkv, lq, d = 4, 1, 32, 256
    for lkv in (704, 4096):
        q = torch.randn(2, lq, hq, d, generator=g, device=cuda_device).to(dtype).transpose(1, 2)
        kv = [torch.randn(2, lkv, hkv, d, generator=g, device=cuda_device) for _ in "kv"]
        q_pos = torch.arange(lkv - 64, lkv - 32, dtype=torch.int32,
                             device=cuda_device).repeat(2, 1)
        kv_pos = torch.arange(lkv, dtype=torch.int32, device=cuda_device).repeat(2, 1)
        kv_pos[1, :7] = -1
        (k8, ks), (v8, vs) = (ref.quantize_rows(t) for t in kv)
        for window in (0, 512):
            for k, v, sc in ((kv[0].to(dtype).transpose(1, 2), kv[1].to(dtype).transpose(1, 2),
                              {}),
                             (k8.transpose(1, 2), v8.transpose(1, 2),
                              dict(k_scale=ks.transpose(1, 2), v_scale=vs.transpose(1, 2)))):
                pl = plan(q, k, v, lkv, hkv)
                assert pl.body == body and (lkv == 704 or body == "cuda_core"
                                            or pl.n_splits > 1)
                got = flash_attention(q, k, v, q_pos, kv_pos, window=window, **sc)
                want = ref.attention_reference(q, k, v, q_pos, kv_pos, window=window, **sc)
                assert (got.float() - want.float()).abs().max().item() <= tol, (lkv, window)
        ps = 16
        n_vp = lkv // ps
        bt = (torch.randperm(2 * n_vp, generator=g, device=cuda_device) + 1).int().view(2, n_vp)
        bt[0, 5] = -1
        pools = [torch.randn(2 * n_vp + 1, ps, hkv, d, generator=g, device=cuda_device)
                 for _ in "kv"]
        (kp8, kps), (vp8, vps) = (ref.quantize_rows(t) for t in pools)
        for window in (0, 512):
            for kp, vp, sc in ((pools[0].to(dtype), pools[1].to(dtype), {}),
                               (kp8, vp8, dict(k_scale=kps, v_scale=vps))):
                assert plan(q, kp, vp, lkv, hkv, ps).body == body
                args = (q, kp, vp, q_pos, kv_pos, bt)
                got = paged_flash_attention(*args, window=window, **sc)
                want = ref.paged_attention_reference(*args, window=window, **sc)
                assert (got.float() - want.float()).abs().max().item() <= tol, (lkv, window)
    idx = torch.stack([torch.randperm(64, generator=g, device=cuda_device)[:32]
                       for _ in range(2)]).to(torch.int32)
    mk = dict(row_mask=torch.tensor([True, True], device=cuda_device),
              token_mask=torch.rand(2, 32, generator=g, device=cuda_device) < 0.8)
    bt = (torch.randperm(8, generator=g, device=cuda_device) + 1).int().view(2, 4)
    new = [torch.randn(2, 32, hkv, d, generator=g, device=cuda_device).to(dtype) for _ in "kv"]
    for paged in (False, True):
        lead = (9, 16) if paged else (2, 64)
        planes = [torch.randint(-127, 128, (*lead, hkv, d), generator=g,
                                device=cuda_device).to(torch.int8) for _ in "kv"]
        scales = [torch.rand(*lead, hkv, generator=g, device=cuda_device) for _ in "kv"]
        want = [t.clone() for t in planes + scales]
        got = [t.clone() for t in planes + scales]
        pairs = (((got[0], got[2]), new[0]), ((got[1], got[3]), new[1]))
        for i in range(2):
            if paged:
                ref.quantize_scatter_rows_paged_reference(want[i], want[i + 2], new[i], idx, bt,
                                                          **mk)
            else:
                ref.quantize_scatter_rows_reference(want[i], want[i + 2], new[i], idx, **mk)
        if paged:
            quantize_scatter_rows_paged(pairs, idx, bt, **mk)
        else:
            quantize_scatter_rows(pairs, idx, **mk)
        cut = 1 if paged else 0
        assert all(torch.equal(a[cut:], b[cut:]) for a, b in zip(got, want))


def _wrapper_calls(dev, grad: bool) -> dict:
    """Each kernel wrapper on small valid inputs on ``dev``, its float input
    (the one a training pass would differentiate) requiring grad when
    ``grad``: name -> a call."""
    from repro_torch.kernels.scatter_kv import quantize_scatter_rows, quantize_scatter_rows_paged

    def f(*shape):
        return torch.randn(*shape, device=dev).requires_grad_(grad)

    def z(*shape, dtype=torch.float32):
        return torch.zeros(*shape, dtype=dtype, device=dev)
    pos = torch.arange(8, dtype=torch.int32, device=dev)[None].contiguous()
    bt = torch.ones(1, 1, dtype=torch.int32, device=dev)

    def q8(*lead):
        return (z(*lead, 2, 32, dtype=torch.int8), z(*lead, 2))
    return {
        "flash_attention": lambda: flash_attention(f(1, 2, 8, 32), z(1, 2, 8, 32),
                                                   z(1, 2, 8, 32), pos, pos),
        "paged_flash_attention": lambda: paged_flash_attention(
            f(1, 2, 8, 32), z(2, 8, 2, 32), z(2, 8, 2, 32), pos, pos, bt),
        "scatter_rows": lambda: scatter_rows(((z(1, 16, 2, 32), f(1, 8, 2, 32)),
                                              (z(1, 16, 2, 32), f(1, 8, 2, 32))), pos),
        "scatter_rows_paged": lambda: scatter_rows_paged(
            ((z(2, 8, 2, 32), f(1, 8, 2, 32)), (z(2, 8, 2, 32), f(1, 8, 2, 32))), pos, bt),
        "quantize_scatter_rows": lambda: quantize_scatter_rows(
            ((q8(1, 16), f(1, 8, 2, 32)), (q8(1, 16), f(1, 8, 2, 32))), pos),
        "quantize_scatter_rows_paged": lambda: quantize_scatter_rows_paged(
            ((q8(2, 8), f(1, 8, 2, 32)), (q8(2, 8), f(1, 8, 2, 32))), pos, bt),
        "fork_pages": lambda: fork_pages(f(1, 4, 8, 2, 32), z(1, 4, 8, 2, 32), [1], [2]),
        "importance": lambda: importance(f(1, 8, 64), z(1, 8, 64), z(1, 8), alpha=0.5),
        "variation": lambda: variation(f(1, 8, 64), z(1, 8, 64), z(1, 8), alpha=0.5),
        "ssd_chunks": lambda: ssd_chunks(f(1, 16, 2, 16), z(1, 16, 2) + 0.1, z(2),
                                         z(1, 16, 1, 16), z(1, 16, 1, 16), chunk=16),
    }


WRAPPERS = list(_wrapper_calls("cpu", False))


@pytest.mark.parametrize("name", WRAPPERS)
def test_wrappers_refuse_inputs_that_require_grad(name):
    """A kernel has no backward, so a wrapper handed an input that requires
    grad raises (naming ``impl="plain"``) before anything else, on any
    device; with grad mode off the same call gets as far as its device
    check."""
    with pytest.raises(RuntimeError, match='requires grad.*impl="plain"'):
        _wrapper_calls("cpu", True)[name]()
    with torch.no_grad(), pytest.raises(ValueError, match="CUDA"):
        _wrapper_calls("cpu", True)[name]()


class _Reached(Exception):
    pass


@pytest.mark.parametrize("arch", ["jamba-v0.1-52b", "seamless-m4t-large-v2"])
def test_training_forward_takes_no_kernel_route(arch, monkeypatch):
    """With every op told its tensors lie on the card, a training loss and
    its backward pass still reach no kernel wrapper: the training forward
    chooses the plain versions itself (``impl="plain"``), whatever the
    device.  Jamba runs attention, the SSD scan and MoE; SeamlessM4T the
    encoder and cross-attention.  The same stack run with ``impl="kernel"``
    reaches a wrapper at once."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.core import prng
    from repro_torch.models import Model
    from repro_torch.train.loss import diffusion_loss

    def reached(*_, **__):
        raise _Reached()
    monkeypatch.setattr(ops, "_on_card", lambda *t: True)
    for name in ("flash_attention", "paged_flash_attention", "scatter_rows_kernel",
                 "scatter_rows_paged_kernel", "quantize_scatter_rows",
                 "quantize_scatter_rows_paged", "fork_pages_kernel", "importance", "variation",
                 "ssd_chunks_kernel"):
        monkeypatch.setattr(ops, name, reached)
    cfg = configs.reduced(configs.get_config(arch))
    if cfg.pattern_period > 1:
        cfg = dataclasses.replace(cfg, n_layers=cfg.pattern_period)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        model = Model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
        model.requires_grad_(True)
        gen = torch.Generator().manual_seed(1)
        tokens = torch.randint(3, cfg.vocab_size, (2, 16), generator=gen, dtype=torch.int32)
        region = torch.ones(2, 16, dtype=torch.bool)
        enc = (torch.randn(2, cfg.n_enc_tokens, cfg.d_enc, generator=gen)
               if cfg.family == "audio" else None)
        loss, _ = diffusion_loss(model, prng.prng_key(0), tokens, region, enc_embeds=enc,
                                 ce_chunk=8)
        loss.backward()
        assert torch.isfinite(loss)
        assert all(p.grad is not None for p in model.parameters())
        with torch.no_grad(), pytest.raises(_Reached):
            model.forward(tokens, enc_embeds=enc, impl="kernel")
    finally:
        torch.set_num_threads(n)


@pytest.mark.cuda
def test_cuda_wrappers_refuse_inputs_that_require_grad(cuda_device):
    """On the card each wrapper raises on an input that requires grad, and
    launches on the same inputs with grad mode off."""
    for name in WRAPPERS:
        with pytest.raises(RuntimeError, match="requires grad"):
            _wrapper_calls(cuda_device, True)[name]()
        with torch.no_grad():
            _wrapper_calls(cuda_device, True)[name]()
    torch.cuda.synchronize()
