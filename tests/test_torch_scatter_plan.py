"""The K/V row scatter's block planner and its masked plain versions, on the CPU.

``scatter_kv.plan`` gives the CUDA kernel its block shape (threads, rows per
block, bytes of a row a group of threads moves).  A Python mirror of the
kernel's block -> (row, byte range) mapping checks that every plan moves
every byte of every (token, tensor) row exactly once and that its grid fits
the launch limits the C entry point enforces.  The plain versions
``ref.scatter_rows_reference`` and ``ref.scatter_rows_paged_reference`` take
the serving masks as the kernel does; they are held against the JAX
reference's ``scatter_rows`` / ``scatter_rows_paged`` (the XLA lowering and
the Pallas kernel in interpret mode) on Dream's GQA layout (4 KV heads) at a
reduced head width.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import build, ref
from repro_torch.kernels import scatter_kv as sk

ROW_BYTES = [128, 1024, 8192, 16384]   # a tiny row, Dream bf16, LLaDA bf16, LLaDA f32


def coverage(pl: sk.Plan, b: int, k: int, pairs: int, row_bytes: int) -> np.ndarray:
    """[b * k, pairs, row_bytes // 16] counts of the 16-byte vectors the
    kernel's threads move, computed as ``scatter_rows_kernel`` maps
    (blockIdx.x, threadIdx.x, u) to (token, tensor, vector), with the entry
    point's splits, pieces and grid."""
    vecs, group, loads = row_bytes // 16, pl.group, sk.LOADS
    splits = -(-row_bytes // pl.chunk_bytes)
    pieces = b * k * pairs * splits
    blocks = pl.blocks(b, k, pairs, row_bytes)
    t = np.arange(pl.threads)
    piece = np.arange(blocks)[:, None] * pl.rows_per_block + t // group     # [blocks, threads]
    row = piece // splits
    tok, z = row // pairs, row % pairs
    v = ((piece - row * splits) * group * loads + t % group)[..., None] \
        + np.arange(loads) * group                                          # [.., loads]
    live = (piece < pieces)[..., None] & (v < vecs)
    flat = ((np.broadcast_to(tok[..., None], v.shape) * pairs
             + np.broadcast_to(z[..., None], v.shape)) * vecs + v)[live]
    return np.bincount(flat, minlength=b * k * pairs * vecs).reshape(b * k, pairs, vecs)


def check_launchable(pl: sk.Plan, b: int, k: int, pairs: int, row_bytes: int) -> None:
    """What ``repro_scatter_rows`` refuses, and the launch limits."""
    assert 1 <= pl.threads <= sk.MAX_THREADS <= 1024
    assert pl.rows_per_block >= 1 and pl.threads % pl.rows_per_block == 0
    assert pl.chunk_bytes == 16 * sk.LOADS * pl.group
    splits = -(-row_bytes // pl.chunk_bytes)
    assert b * k * pairs * splits + pl.rows_per_block <= sk.GRID_LIMIT
    assert 1 <= pl.blocks(b, k, pairs, row_bytes) <= sk.GRID_LIMIT


@pytest.mark.parametrize("b", [1, 2, 4])
@pytest.mark.parametrize("k", [1, 8, 16, 32, 40, 192])
@pytest.mark.parametrize("row_bytes", ROW_BYTES)
def test_plan_moves_every_byte_once(row_bytes, k, b):
    for pairs in (1, 2):
        pl = sk.plan(b, k, pairs, row_bytes)
        check_launchable(pl, b, k, pairs, row_bytes)
        counts = coverage(pl, b, k, pairs, row_bytes)
        assert (counts == 1).all(), (pl, np.unique(counts))


@pytest.mark.parametrize("b,k", [(2, 8), (2, 32), (4, 32), (4, 192)])
@pytest.mark.parametrize("row_bytes", [16, 48, 20480, 32768])
def test_odd_and_long_rows_move_every_byte_once(row_bytes, b, k):
    """Rows shorter than a group's loads (idle lanes), and rows past 16 KB
    (80 heads of 128 in bf16, 64 in f32), which the planner cuts across
    blocks, the last piece of a 20 KB row shorter than the others."""
    pl = sk.plan(b, k, 2, row_bytes)
    check_launchable(pl, b, k, 2, row_bytes)
    assert (pl.chunk_bytes < row_bytes) == (row_bytes > 16384)
    assert (coverage(pl, b, k, 2, row_bytes) == 1).all(), pl


def test_plan_shapes():
    """Each thread keeps 4 loads in flight; a row takes one group of
    threads up to 16 KB (LLaDA f32) and is cut beyond; 1 KB rows at a
    prefill's size pack several into a block; batches past 65,535 (the old
    grid's y limit) plan and fit the grid."""
    for row_bytes in (1024, 8192, 16384):
        pl = sk.plan(2, 8, 2, row_bytes)              # a skip stage: few rows
        assert pl.chunk_bytes == row_bytes and pl.rows_per_block == 1
    assert sk.plan(2, 8, 2, 32768).chunk_bytes == 16384
    prefill = sk.plan(4, 192, 2, 1024)               # Dream served prefill: 1,536 rows of 1 KB
    assert prefill.rows_per_block > 1 and prefill.blocks(4, 192, 2, 1024) >= build.WAVE
    big = sk.plan(70_000, 192, 2, 1024)
    check_launchable(big, 70_000, 192, 2, 1024)


@pytest.mark.parametrize("args", [(2, 8, 2, 100), (2, 8, 2, 0), (0, 8, 2, 1024),
                                  (2, 0, 2, 1024), (2**20, 2**10, 2, 16384)])
def test_plan_refuses(args):
    with pytest.raises(ValueError, match="scatter plan"):
        sk.plan(*args)


# ---------------------------------------------------------------------------
# the masked plain versions against the JAX reference
MASKS = [("row", None), (None, "token"), ("row", "token")]
HKV, D = 4, 16            # Dream's 4 KV heads, head width cut from 128


def _masks(rng, b, k, which):
    row = rng.permutation(np.arange(b) % 2 == 0) if which[0] else None
    tok = rng.uniform(size=(b, k)) < 0.5 if which[1] else None
    return row, tok


def _t(x):
    return None if x is None else torch.from_numpy(np.ascontiguousarray(x))


def _j(x):
    return None if x is None else jnp.asarray(x)


@pytest.mark.parametrize("which", MASKS, ids=["row", "token", "row+token"])
@pytest.mark.parametrize("impl", ["pallas", "xla"])
def test_dense_reference_masks_match_jax(which, impl):
    rng = np.random.default_rng(11 + len(which[0] or "") + 3 * len(which[1] or ""))
    b, s, k = 4, 24, 8
    cache = rng.standard_normal((b, s, HKV, D), np.float32)
    new = rng.standard_normal((b, k, HKV, D), np.float32)
    idx = np.stack([rng.permutation(s)[:k] for _ in range(b)]).astype(np.int32)
    row, tok = _masks(rng, b, k, which)
    want = np.asarray(jops.scatter_rows(jnp.asarray(cache), jnp.asarray(new), jnp.asarray(idx),
                                        impl=impl, row_mask=_j(row), token_mask=_j(tok)))
    got = ref.scatter_rows_reference(torch.from_numpy(cache.copy()), _t(new), _t(idx),
                                     row_mask=_t(row), token_mask=_t(tok))
    np.testing.assert_array_equal(got.numpy(), want)
    assert not np.array_equal(want, cache), "the case wrote nothing"
    assert not np.array_equal(
        want, np.asarray(jops.scatter_rows(jnp.asarray(cache), jnp.asarray(new),
                                           jnp.asarray(idx), impl="xla"))), "no mask bit"


@pytest.mark.parametrize("page_size", [8, 16])
@pytest.mark.parametrize("which", MASKS, ids=["row", "token", "row+token"])
@pytest.mark.parametrize("impl", ["pallas", "xla"])
def test_paged_reference_masks_match_jax(page_size, which, impl):
    """Pages 1 and up are bit-equal; page 0 is the garbage page, where the
    reference also routes masked rows and the port writes nothing."""
    rng = np.random.default_rng(page_size + len(which[0] or "") + 3 * len(which[1] or ""))
    b, n_vp, k = 4, 4, 8
    t_total, n_pages = n_vp * page_size, b * n_vp + 1
    bt = (rng.permutation(b * n_vp) + 1).astype(np.int32).reshape(b, n_vp)
    bt[1, 0] = -1                                     # an unmapped page
    pool = rng.standard_normal((n_pages, page_size, HKV, D), np.float32)
    new = rng.standard_normal((b, k, HKV, D), np.float32)
    idx = np.stack([rng.permutation(t_total)[:k] for _ in range(b)]).astype(np.int32)
    row, tok = _masks(rng, b, k, which)
    want = np.asarray(jops.scatter_rows_paged(
        jnp.asarray(pool), jnp.asarray(new), jnp.asarray(idx), jnp.asarray(bt),
        page_size=page_size, impl=impl, row_mask=_j(row), token_mask=_j(tok)))
    got = ref.scatter_rows_paged_reference(torch.from_numpy(pool.copy()), _t(new), _t(idx),
                                           _t(bt), row_mask=_t(row), token_mask=_t(tok))
    np.testing.assert_array_equal(got.numpy()[1:], want[1:])
    assert not np.array_equal(want[1:], pool[1:]), "the case wrote nothing"


def quant_coverage(pl: sk.QuantPlan, b: int, k: int, hkv: int, dh: int) -> np.ndarray:
    """[b * k, 2, hkv, dh] counts of the elements the quantizing kernel's
    threads hold, as ``quant_scatter_kernel`` maps (blockIdx.x, threadIdx.x)
    to (item = (token, K or V, head), elements 4t .. 4t + 3)."""
    items = b * k * 2 * hkv
    t = np.arange(pl.threads)
    item = np.arange(pl.blocks(b, k, hkv))[:, None] * pl.per_block + t // pl.group
    e = pl.elems
    d = np.broadcast_to((e * (t % pl.group))[None, :, None] + np.arange(e), item.shape + (e,))
    live = (item < items)[..., None] & (d < dh)
    flat = (item[..., None] * dh + d)[live]
    return np.bincount(flat, minlength=items * dh).reshape(b * k, 2, hkv, dh)


@pytest.mark.parametrize("b,k", [(1, 1), (2, 8), (4, 32), (2, 192), (4, 192)])
@pytest.mark.parametrize("hkv,dh", [(32, 128), (4, 128), (4, 32), (1, 32), (2, 80), (3, 4),
                                    (1, 256), (2, 136)],
                         ids=["llada", "dream", "reduced_llada", "reduced_dream", "d80", "d4",
                              "gemma3", "d136"])
def test_quant_plan_holds_every_element_once(hkv, dh, k, b):
    """Every element of every (token, K or V, head) is held by exactly one
    thread, a group's xor shuffles stay inside it (a power of two of
    threads that covers Dh / 4), blocks are whole warps within the launch
    bound, and the grid fits what ``repro_quant_scatter_rows`` takes."""
    pl = sk.quant_plan(b, k, hkv, dh)
    assert (quant_coverage(pl, b, k, hkv, dh) == 1).all()
    assert pl.group & (pl.group - 1) == 0 and pl.group * pl.elems >= dh and pl.group <= 32
    assert pl.elems == (8 if dh > 128 else 4)
    assert pl.threads % 32 == 0 and pl.threads <= sk.MAX_THREADS
    assert b * k * 2 * hkv + pl.per_block <= sk.GRID_LIMIT


def test_quant_plan_shapes():
    """LLaDA's decode block fills blocks of 8 items; Dream's few items keep
    whole warps; Gemma-3's head of 256 takes 8 elements a thread, one warp
    an item.  Past 128 a head must be a multiple of 8, and at most 256."""
    assert sk.quant_plan(4, 32, 32, 128) == sk.QuantPlan(32, 8)
    assert sk.quant_plan(1, 1, 1, 32) == sk.QuantPlan(8, 4)
    assert sk.quant_plan(4, 32, 1, 256) == sk.QuantPlan(32, 1, 8)
    for args in ((2, 8, 4, 130), (2, 8, 4, 132), (2, 8, 4, 264), (2, 8, 4, 512), (2, 8, 4, 0),
                 (0, 8, 4, 128)):
        with pytest.raises(ValueError):
            sk.quant_plan(*args)
