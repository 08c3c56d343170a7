"""The split-KV attention algebra, its planner and the choice of kernel body.

``ref.attention_split_reference`` and its paged twin compute each split's
partial (O, m, l) over the planner's split boundaries and merge them by
log-sum-exp, as the tensor-core attention kernel does; here they are held
against the JAX reference's XLA path (dense and paged) on the same numpy
inputs, in f32.  The planner (``plan_splits``) and the body choice
(``plan``) are host code and run here on CPU tensors; the kernels
themselves are held against these plain versions by the ``cuda``-marked test
in ``test_torch_kernels.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import ref
from repro_torch.kernels.flash_attention import (MAX_SPLITS, MIN_SPLIT_TILES, TARGET_BLOCKS,
                                                 TILE, plan, plan_splits)

ATOL = 1e-5   # f32: the two sides sum the softmax in different orders
LKV = 300     # five 64-row tiles, the last ragged (44 rows)


def _dense_inputs(seed, hq, hkv, lq, d=32, b=2):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, hq, lq, d), np.float32)
    k = rng.standard_normal((b, hkv, LKV, d), np.float32)
    v = rng.standard_normal((b, hkv, LKV, d), np.float32)
    q_pos = np.tile(np.arange(LKV - lq, LKV, dtype=np.int32), (b, 1))
    kv_pos = np.tile(np.arange(LKV, dtype=np.int32), (b, 1))
    return q, k, v, q_pos, kv_pos


# (name, Hq, Hkv, Lq, mask kwargs, edit)
SPLIT_CASES = [
    ("mha", 4, 4, 8, {}, None),
    ("gqa_28_4", 28, 4, 8, {}, None),
    ("masked_split", 4, 2, 8, {}, "masked_split"),
    ("nothing_valid_row", 28, 4, 8, {"causal": True}, "nothing_valid"),
    ("causal_window_anchor", 4, 2, 16, {"causal": True, "window": 90, "anchor": 20}, None),
    ("block_causal", 4, 2, 8, {"bc_start": 200, "bc_block": 32}, "masked_split"),
]


@pytest.mark.parametrize("n_splits", [1, 2, 3, 5])
@pytest.mark.parametrize("case", SPLIT_CASES, ids=[c[0] for c in SPLIT_CASES])
def test_split_reference_matches_jax(case, n_splits):
    name, hq, hkv, lq, kw, edit = case
    q, k, v, q_pos, kv_pos = _dense_inputs(len(name) + n_splits, hq, hkv, lq)
    if edit in ("masked_split", "nothing_valid"):
        kv_pos[:, 128:192] = -1           # with 3 or 5 splits, one split has no valid key
        kv_pos[1, 0:64] = -1
    if edit == "nothing_valid":
        q_pos[0, 2] = -1                  # causal: no key has kv_pos <= -1
    want = np.asarray(jops.attention(*(jnp.asarray(a) for a in (q, k, v, q_pos, kv_pos)),
                                     impl="xla", **kw))
    got = ref.attention_split_reference(*(torch.from_numpy(a) for a in (q, k, v, q_pos, kv_pos)),
                                        n_splits=n_splits, **kw)
    assert got.shape == (2, hq, lq, 32) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)
    if edit == "nothing_valid":
        assert np.all(got.numpy()[0, :, 2] == 0.0)


def _paged_inputs(seed, page_size, hq, hkv, n_vp, b=3, d=32):
    """Block tables over a shuffled pool with unmapped pages: row 0 has its
    first 64 KV rows unmapped (a whole split), row 1 pages in the middle,
    row 2 nothing mapped."""
    rng = np.random.default_rng(seed)
    num_pages = b * n_vp + 5
    bt = rng.permutation(np.arange(1, num_pages))[: b * n_vp].astype(np.int32).reshape(b, n_vp)
    bt[0, : 64 // page_size] = -1
    bt[1, 3:6] = -1
    bt[2, :] = -1
    t_total = n_vp * page_size
    kv_pos = np.tile(np.arange(t_total, dtype=np.int32), (b, 1))
    kv_pos[1, :5] = -1
    pool_k, pool_v = (rng.standard_normal((num_pages, page_size, hkv, d), np.float32)
                      for _ in "kv")
    q = rng.standard_normal((b, hq, 8, d), np.float32)
    q_pos = rng.integers(0, t_total, (b, 8)).astype(np.int32)
    return q, pool_k, pool_v, q_pos, kv_pos, bt


@pytest.mark.parametrize("n_splits", [1, 2, 3, 5])
@pytest.mark.parametrize("page_size", [8, 16])
@pytest.mark.parametrize("hq,hkv", [(4, 4), (28, 4)], ids=["mha", "gqa_28_4"])
def test_paged_split_reference_matches_jax(page_size, hq, hkv, n_splits):
    n_vp = -(-LKV // page_size)           # 304 or 312 rows: five tiles, the last ragged
    arrays = _paged_inputs(page_size + n_splits + hq, page_size, hq, hkv, n_vp)
    want = np.asarray(jops.paged_attention(*(jnp.asarray(a) for a in arrays),
                                           page_size=page_size, impl="xla"))
    got = ref.paged_attention_split_reference(*(torch.from_numpy(a) for a in arrays),
                                              n_splits=n_splits)
    assert got.shape == (3, hq, 8, 32) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)
    assert np.all(got.numpy()[2] == 0.0)       # nothing mapped: every row writes 0


def test_split_bounds_refuse_an_empty_split():
    assert ref.split_bounds(300, 3) == [(0, 128), (128, 256), (256, 300)]
    with pytest.raises(ValueError, match="empty split"):
        ref.split_bounds(256, 3)                # 4 tiles: 2 + 2, a third would be empty


@pytest.mark.parametrize("page_size", [0, 1, 8, 16])
def test_plan_splits_cover_the_kv_rows(page_size):
    """Every plan's splits tile [0, Lkv) exactly, none empty, at most
    MAX_SPLITS, none but the last shorter than MIN_SPLIT_TILES, and the grid
    reaches TARGET_BLOCKS where the KV rows allow: else no split count
    between the target's and the largest allowed gives whole splits."""
    for n_blocks in (1, 4, 16, 33, 64, 128, 192, 400):
        for lkv in (1, 64, 65, 192, 300, 1000, 4096, 70_000):
            if page_size:
                lkv = -(-lkv // page_size) * page_size
            n_splits, tiles = plan_splits(n_blocks, lkv, page_size)
            n_tiles = -(-lkv // TILE)
            bounds = ref.split_bounds(lkv, n_splits)
            assert bounds[0][0] == 0 and bounds[-1][1] == lkv
            assert all(a < e for a, e in bounds)
            assert all(e == a2 for (_, e), (a2, _) in zip(bounds, bounds[1:]))
            assert tiles == -(-n_tiles // n_splits)
            if page_size:                       # a split's pages fit the shared page table
                assert (tiles * TILE + page_size - 1) // page_size + 1 <= 1024
            else:
                assert n_splits <= MAX_SPLITS
                assert n_splits == 1 or tiles >= MIN_SPLIT_TILES
                top = min(MAX_SPLITS, n_tiles // MIN_SPLIT_TILES)
                if n_blocks * n_splits < TARGET_BLOCKS:
                    whole = [c for c in range(n_splits + 1, top + 1)
                             if -(-n_tiles // -(-n_tiles // c)) == c]
                    assert whole == []


def _view(dtype, d, pad=0, b=2, h=4, n=40):
    """[B, H, L, D] as the path lays it out: [B, L, H, D + pad] cut to D."""
    return torch.zeros(b, n, h, d + pad, dtype=dtype)[..., :d].transpose(1, 2)


@pytest.mark.parametrize("dtype,d,pad,body", [
    (torch.bfloat16, 128, 0, "tensor_core"),
    (torch.bfloat16, 80, 0, "tensor_core"),
    (torch.bfloat16, 16, 0, "tensor_core"),
    (torch.float32, 128, 0, "cuda_core"),
    (torch.bfloat16, 72, 0, "cuda_core"),
    (torch.bfloat16, 100, 0, "cuda_core"),
    (torch.bfloat16, 64, 2, "cuda_core"),
    (torch.bfloat16, 256, 0, "tensor_core"),
    (torch.bfloat16, 192, 0, "cuda_core"),
    (torch.float32, 256, 0, "cuda_core"),
], ids=["bf16_d128", "bf16_d80", "bf16_d16", "f32", "bf16_d72", "bf16_d100",
        "bf16_unaligned_strides", "bf16_d256", "bf16_d192", "f32_d256"])
def test_body_choice(dtype, d, pad, body):
    q, k, v = _view(dtype, d, pad, n=8), _view(dtype, d, pad, h=2), _view(dtype, d, pad, h=2)
    p = plan(q, k, v, 40, 2)
    assert p.body == body
    if body == "tensor_core":
        # 2 x 8 = 16 packed rows per KV head: 4 warps share one 16-row slab;
        # 2 batch x 2 KV heads x 1 row tile; 40 KV rows are one tile: no split
        assert (p.ks, p.n_splits, p.split_tiles, p.row_tiles) == (4, 1, 1, 1)
    pools = torch.zeros(9, 16, 2, d, dtype=dtype)
    assert plan(q, pools, pools, 64, 2, page_size=16).body == body


@pytest.mark.parametrize("b,hq,hkv,lq,lkv,want", [
    # (ks, row_tiles, n_splits, split_tiles)
    (2, 32, 32, 32, 192, (4, 2, 1, 3)),     # LLaDA block: 64 blocks -> 16-row blocks
    (2, 32, 32, 8, 192, (4, 1, 1, 3)),      # LLaDA skip: 8 rows, every warp on keys
    (4, 32, 32, 32, 192, (2, 1, 1, 3)),     # 4 slots: 128 blocks of 32 rows
    (2, 32, 32, 192, 192, (1, 3, 1, 3)),    # prefill: 192 blocks of 64 rows
    (2, 28, 4, 32, 192, (4, 14, 1, 3)),     # Dream: 7 x 32 = 224 packed rows per KV head
    (4, 28, 4, 32, 192, (2, 7, 1, 3)),
    (1, 28, 4, 32, 1580, (4, 14, 2, 13)),   # a long cache: 56 blocks, split in two
    (1, 32, 32, 32, 1580, (4, 2, 2, 13)),
], ids=["llada_block", "llada_skip", "llada_4_slots", "llada_prefill", "dream_block",
        "dream_4_slots", "dream_long", "llada_long"])
def test_plan_packs_rows_and_splits(b, hq, hkv, lq, lkv, want):
    """The row packing (GQA heads x query rows), the key-split warps and the
    KV splits the planner gives the paths' shapes."""
    q = _view(torch.bfloat16, 128, b=b, h=hq, n=lq)
    k = _view(torch.bfloat16, 128, b=b, h=hkv, n=lkv)
    p = plan(q, k, k, lkv, hkv)
    assert p.body == "tensor_core"
    assert (p.ks, p.row_tiles, p.n_splits, p.split_tiles) == want


@pytest.mark.parametrize("bc_start,bc_block", [(0, 8), (24, 8), (128, 32), (100, 7)])
def test_block_causal_row_bound_equals_block_rule(bc_start, bc_block):
    """The tensor-core body applies block-causal masking as one bound per
    query row, ``kv_pos < bc_start + (qb + 1) * bc_block`` with ``qb`` the
    row's block (-1 for the prompt): it must admit exactly the keys whose
    block is at most the row's, as ``ref.attention_mask`` decides."""
    pos = torch.arange(-1, 3 * bc_start + 4 * bc_block, dtype=torch.int32)
    q_pos, kv_pos = pos[None], pos[None]
    want = ref.attention_mask(q_pos, kv_pos, bc_start=bc_start, bc_block=bc_block)[0]
    qp = pos.long()
    qb = torch.where(qp >= bc_start, torch.div(qp - bc_start, bc_block, rounding_mode="trunc"),
                     -1)
    lim = bc_start + (qb + 1) * bc_block
    got = (pos[None, :] >= 0) & (pos[None, :].long() < lim[:, None])
    assert torch.equal(got, want)


@pytest.mark.parametrize("qdtype,d,pad,body", [
    (torch.bfloat16, 128, 0, "tensor_core"),
    (torch.bfloat16, 32, 0, "tensor_core"),
    (torch.float32, 128, 0, "cuda_core"),
    (torch.bfloat16, 72, 0, "cuda_core"),
    (torch.bfloat16, 64, 8, "cuda_core"),
    (torch.bfloat16, 256, 0, "tensor_core"),
], ids=["bf16_q_d128", "bf16_q_d32", "f32_q", "bf16_q_d72", "bf16_q_unaligned_codes",
        "bf16_q_d256"])
def test_int8_kv_body_choice(qdtype, d, pad, body):
    """int8 K/V (the int8 cache's codes) with bf16 q take the tensor-core
    body when every code row is a multiple of 16 bytes (head_dim a multiple
    of 16, strides aligned), with f32 q the CUDA-core body (the reference's
    exact dequant); the same plan as bf16 K/V of that shape, dense and
    paged."""
    q = _view(qdtype, d, n=8)
    k8 = _view(torch.int8, d, pad, h=2)
    p = plan(q, k8, k8, 40, 2)
    assert p.body == body
    if body == "tensor_core":
        kb = _view(torch.bfloat16, d, h=2)
        assert p == plan(q, kb, kb, 40, 2)
    pools = torch.zeros(9, 16, 2, d + pad, dtype=torch.int8)[..., :d]
    assert plan(q, pools, pools, 64, 2, page_size=16).body == body
