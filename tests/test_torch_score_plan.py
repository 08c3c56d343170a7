"""The score kernel's block planner and the indexed plain importance, on the CPU.

``importance.plan`` gives the CUDA score kernel (Eq. 1 importance and the
variation score) its block shape: threads a row (a block scores one row) and
16-byte loads a thread.  A Python mirror of the kernel's block -> (row,
vector, element) mapping checks that every plan reads every element of every
row exactly once and that its launch is one the C entry point takes, at the
paths' widths (mamba2-370m's d 1024, Dream's 3584, LLaDA's 4096), a small
one and a long one, on the vector path and on the scalar head and tail of
rows off a 16-byte boundary.
``ref.importance_reference(..., idx=...)``, the plain version of the skip
stage's scoring with the row gathers in it, is held against the JAX engine's
``_row_gather`` followed by the reference's Pallas kernel in interpret mode.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.engine import _row_gather
from repro.kernels import ops as jops
from repro_torch.kernels import importance as imp
from repro_torch.kernels import ops, ref

ROWS = [1, 32, 128, 768]   # one row; skip stages' B * K; variation's 4 * 192


def head_of(d: int, elem: int, mis_h: int, mis_o: int) -> int:
    """The kernel's scalar head of a row whose Hn and Ho start ``mis_h`` and
    ``mis_o`` bytes past a 16-byte boundary: up to the boundary when the two
    agree, the whole row when they do not."""
    return min(d, (16 - mis_h) % 16 // elem) if mis_h == mis_o else d


def coverage(pl: imp.Plan, rows: int, d: int, elem: int, head: int = 0) -> np.ndarray:
    """[rows, d] counts of the elements the kernel's threads read, computed
    as ``score_kernel`` maps (blockIdx.x, threadIdx.x) to (row, t) and t to
    the vectors ``t + (trip * loads + u) * group`` after the scalar head and
    the scalar elements ``t + j * group`` of the head and the tail."""
    w = 16 // elem
    nvec = (d - head) // w
    row, t = np.meshgrid(np.arange(rows), np.arange(pl.group), indexing="ij")
    counts = np.zeros((rows, d), np.int64)
    for trip in range(max(1, -(-nvec // (pl.group * pl.loads)))):
        for u in range(pl.loads):
            v = t + (trip * pl.loads + u) * pl.group
            ok = v < nvec
            for e in range(w):
                np.add.at(counts, (row[ok], head + v[ok] * w + e), 1)
    for lo, hi in ((0, head), (head + nvec * w, d)):
        for j in range(-(-(hi - lo) // pl.group)):
            e = lo + t + j * pl.group
            ok = e < hi
            np.add.at(counts, (row[ok], e[ok]), 1)
    return counts


def check_launchable(pl: imp.Plan) -> None:
    """What ``repro_importance`` takes: a block of 32, 64, 128 or 256
    threads (256 is the kernel's launch bound), 1, 2 or 4 loads."""
    assert pl.group in (32, 64, 128, 256) and pl.loads in (1, 2, 4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [256, 1024, 3584, 4096, 8192])
def test_plan_reads_every_element_once(d, dtype):
    """Rows on 16-byte boundaries, read through an index or not (the
    mapping is the same): vectors only, a row past 16 KB in two trips."""
    pl = imp.plan(d, dtype)
    check_launchable(pl)
    for rows in ROWS:
        counts = coverage(pl, rows, d, dtype.itemsize)
        assert (counts == 1).all(), (rows, pl, np.unique(counts))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [3, 100, 1001, 3585])
@pytest.mark.parametrize("mis", [(0, 0), (4, 4), (8, 12), (12, 12)])
def test_ragged_rows_read_every_element_once(mis, d, dtype):
    """Rows off a 16-byte boundary (d * elem not a multiple of 16, or a
    base that is not aligned): a scalar head up to the boundary, vectors,
    a scalar tail; element by element where Hn and Ho disagree (a row read
    through ``idx`` whose cached row starts elsewhere in its 16 bytes)."""
    elem = dtype.itemsize
    head = head_of(d, elem, *mis)
    pl = imp.plan(d, dtype)
    check_launchable(pl)
    counts = coverage(pl, 8, d, elem, head)
    assert (counts == 1).all(), (pl, head, np.unique(counts))


def test_plan_shapes():
    """A thread for each vector of a row up to 256, then up to 4 loads a
    thread: LLaDA's d 4096 takes 256 threads of 4 loads in f32 and of 2 in
    bf16, Dream's f32 rows (896 vectors) a ragged trip of 256 x 4,
    mamba2-370m's d 1024 one load a thread, a row past 16 KB two trips."""
    assert imp.plan(4096, torch.float32) == imp.Plan(256, 4)
    assert imp.plan(4096, torch.bfloat16) == imp.Plan(256, 2)
    assert imp.plan(3584, torch.float32) == imp.Plan(256, 4)
    assert imp.plan(3584, torch.bfloat16) == imp.Plan(256, 2)
    assert imp.plan(1024, torch.float32) == imp.Plan(256, 1)
    assert imp.plan(1024, torch.bfloat16) == imp.Plan(128, 1)
    assert imp.plan(8192, torch.float32) == imp.Plan(256, 4)
    assert imp.plan(256, torch.float32) == imp.Plan(64, 1)
    assert imp.plan(24, torch.float32) == imp.Plan(32, 1)          # at least a warp


@pytest.mark.parametrize("args", [(0, torch.float32), (64, torch.float16)])
def test_plan_refuses(args):
    with pytest.raises(ValueError, match="score plan"):
        imp.plan(*args)


# ---------------------------------------------------------------------------
# the indexed plain importance against the JAX engine's gather + Pallas kernel
def _skip_inputs(seed, b, s, k, d, kind):
    rng = np.random.default_rng(seed)
    hn = rng.standard_normal((b, k, d), np.float32)
    ho = rng.standard_normal((b, s, d), np.float32)
    conf = rng.uniform(size=(b, s)).astype(np.float32)
    if kind == "permuted":
        idx = np.stack([rng.permutation(s)[:k] for _ in range(b)])
    elif kind == "repeated":          # a row read by several of the stage's rows
        idx = rng.integers(0, s // 4, size=(b, k))
    else:                             # the first stage's rows 0..k-1 of the block
        idx = np.tile(np.arange(k), (b, 1))
    return hn, ho, conf, idx.astype(np.int32)


@pytest.mark.parametrize("kind", ["identity", "permuted", "repeated"])
@pytest.mark.parametrize("alpha", [0.0, 0.5, 1.0])
def test_indexed_reference_matches_jax(kind, alpha):
    """A skip stage of a reduced-width block: 16 block rows, 8 of them
    scored, d 64; the indexed call equals gather-then-score in both
    packages."""
    hn, ho, conf, idx = _skip_inputs(len(kind) + int(10 * alpha), 3, 16, 8, 64, kind)
    j_idx = jnp.asarray(idx)
    want = np.asarray(jops.importance_score(
        jnp.asarray(hn), _row_gather(jnp.asarray(ho), j_idx), _row_gather(jnp.asarray(conf), j_idx),
        alpha=alpha, impl="pallas"))
    got = ref.importance_reference(torch.from_numpy(hn), torch.from_numpy(ho),
                                   torch.from_numpy(conf), alpha, idx=torch.from_numpy(idx))
    assert got.dtype == torch.float32 and got.shape == (3, 8)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    via_ops = ops.importance_score(torch.from_numpy(hn), torch.from_numpy(ho),
                                   torch.from_numpy(conf), alpha=alpha,
                                   idx=torch.from_numpy(idx))
    assert torch.equal(via_ops, got)


def test_indexed_reference_is_gather_then_score():
    """The indexed plain version is the unindexed one on the gathered rows,
    bit for bit, a zero cached row included."""
    hn, ho, conf, idx = _skip_inputs(5, 2, 32, 16, 48, "permuted")
    ho[1, idx[1, 3]] = 0.0
    t = [torch.from_numpy(x) for x in (hn, ho, conf, idx)]
    li = t[3].long()
    gathered = (torch.gather(t[1], 1, li[..., None].expand(-1, -1, 48)),
                torch.gather(t[2], 1, li))
    want = ref.importance_reference(t[0], *gathered, 0.5)
    assert torch.equal(ref.importance_reference(t[0], t[1], t[2], 0.5, idx=t[3]), want)
