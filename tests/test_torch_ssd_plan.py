"""The SSD chunk kernel's planner and the tensor-core body's numerics.

``plan`` (which body, how many heads a block) is host code and runs here on
CPU tensors.  ``ref.ssd_chunks_tc`` is the plain mirror of the tensor-core
body's roundings (bf16 operands, f32 sums; y_intra's scores and contrib's
right operand each split into a bf16 high part and remainder); it is held against the JAX ``ssd_chunk_kernel`` in interpret mode on the same
bf16-representable numpy inputs, at mamba2-370m's widths (N 128, P 64): the
decode shape (one chunk of 32) and a prefill chunk of 64.  Tolerances are the
card's for the kernel: 1e-2 abs + rel on bf16 y_intra, 1e-4 on contrib, decay
and cs.  The CUDA body itself is held against ``ref.ssd_chunks`` by the
``cuda``-marked test in ``test_torch_kernels.py`` and by ``chip_smoke.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssd_scan import ssd_chunk_kernel
from repro_torch.kernels import ref
from repro_torch.kernels.ssd_scan import (HEADS_PER_BLOCK, RESIDENT_BLOCKS, SMEM_LIMIT,
                                          TC_CHUNKS, plan, smem_bytes_tc)

H, G = 4, 1


def _views(dtype, chunk, n, p, *, b=2, h=H, g=G, nc=2, pad=0, offset=0):
    """x [B, L, H, P] and B, C as views of one [B, L, 2GN + pad] projection,
    as the mixer makes them; ``offset`` shifts both views by elements."""
    l = chunk * nc
    x = torch.zeros(b, l, h, p, dtype=dtype)
    bc = torch.zeros(b, l, 2 * g * n + pad + offset, dtype=dtype)
    bm = bc[..., offset:offset + g * n].reshape(b, l, g, n)
    cm = bc[..., offset + g * n:offset + 2 * g * n].reshape(b, l, g, n)
    return x, bm, cm


@pytest.mark.parametrize("p", [16, 64])
@pytest.mark.parametrize("n", [8, 128])
@pytest.mark.parametrize("chunk", [8, 16, 32, 48, 64])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_body_choice(dtype, chunk, n, p):
    """bf16, a chunk that is a multiple of 16 up to 64 (48 too), N and P
    multiples of 16 take the tensor-core body; f32, chunk 8 or N 8 do not."""
    x, bm, cm = _views(dtype, chunk, n, p)
    want = ("tensor_core" if dtype == torch.bfloat16 and chunk in (16, 32, 48, 64)
            and n % 16 == 0 and p % 16 == 0 else "cuda_core")
    assert plan(x, bm, chunk, cm).body == want
    assert set(TC_CHUNKS) == {16, 32, 48, 64}


@pytest.mark.parametrize("pad,offset", [(1, 0), (0, 1), (8, 0)],
                         ids=["odd_row_stride", "odd_base", "aligned_wider_rows"])
def test_unaligned_views_take_cuda_core(pad, offset):
    """B/C views whose rows or base are off 16-byte boundaries go to the
    CUDA-core body; a wider row that stays a multiple of 16 bytes does not."""
    x, bm, cm = _views(torch.bfloat16, 32, 128, 64, pad=pad, offset=offset)
    want = "tensor_core" if (pad * 2) % 16 == 0 and (offset * 2) % 16 == 0 else "cuda_core"
    assert plan(x, bm, 32, cm).body == want
    if offset:                                     # C alone off its boundary
        x, bm, _ = _views(torch.bfloat16, 32, 128, 64)
        _, _, cm_off = _views(torch.bfloat16, 32, 128, 64, offset=offset)
        assert plan(x, bm, 32, cm_off).body == "cuda_core"


# (B, chunks, H, G, chunk, heads per block the rule gives)
GRIDS = [
    (4, 1, 32, 1, 32, 1),     # mamba2-370m decode: 128 blocks at one head
    (4, 3, 32, 1, 64, 2),     # mamba2-370m prefill: 384 blocks at 1, 192 at 2
    (4, 3, 32, 2, 64, 2),     # two groups of 16 heads
    (4, 4, 32, 1, 16, 2),     # 512 blocks at 1, 256 at 2
    (2, 2, 32, 1, 16, 1),
    (1, 1, 8, 1, 32, 1),      # 8 blocks
    (16, 4, 32, 1, 32, 8),    # 2048 blocks at 1, 256 at 8
    (64, 4, 32, 1, 64, 8),    # past one wave at any HB: the most
    (8, 3, 24, 8, 16, 1),     # 3 heads a group: only 1 divides
    (8, 6, 12, 2, 16, 2),     # 6 heads a group: 2 divides, 288 blocks
]


@pytest.mark.parametrize("b,nc,h,g,chunk,want", GRIDS)
def test_heads_per_block(b, nc, h, g, chunk, want):
    """HB divides the heads of a group; it is the fewest that bring the grid
    within one wave of resident blocks, or, when none does, the most."""
    x, bm, cm = _views(torch.bfloat16, chunk, 128, 64, b=b, h=h, g=g, nc=nc)
    pl = plan(x, bm, chunk, cm)
    hb = pl.heads_per_block
    assert pl.body == "tensor_core" and hb == want and hb in HEADS_PER_BLOCK
    divide = [c for c in HEADS_PER_BLOCK if (h // g) % c == 0]
    in_wave = [c for c in divide if b * nc * h // c <= RESIDENT_BLOCKS]
    assert hb == (min(in_wave) if in_wave else max(divide))
    assert hb == 1 or b * nc * h // hb >= RESIDENT_BLOCKS // 4


# Jamba's mixer (128 heads of 64, d_state 64, one group): (B, L, chunk,
# heads per block) at the offline decode and prefill and the served ones
JAMBA_GRIDS = [
    (2, 32, 32, 1),           # offline decode: 256 blocks at one head
    (4, 32, 32, 2),           # served decode: 512 blocks at 1, 256 at 2
    (2, 192, 64, 4),          # offline prefill: 768 blocks at 1, 192 at 4
    (4, 192, 64, 8),          # served prefill: 1,536 blocks at 1, 192 at 8
]


@pytest.mark.parametrize("b,l,chunk,want", JAMBA_GRIDS)
def test_jamba_widths_take_the_tensor_core_body(b, l, chunk, want):
    """At Jamba's widths bf16 takes the tensor-core body with the rule's
    heads per block, in shared memory; f32 takes the CUDA-core body."""
    x, bm, cm = _views(torch.bfloat16, chunk, 64, 64, b=b, h=128, nc=l // chunk)
    pl = plan(x, bm, chunk, cm)
    assert (pl.body, pl.heads_per_block) == ("tensor_core", want)
    assert smem_bytes_tc(chunk, 64, 64, want) < SMEM_LIMIT
    x, bm, cm = _views(torch.float32, chunk, 64, 64, b=b, h=128, nc=l // chunk)
    assert plan(x, bm, chunk, cm).body == "cuda_core"


@pytest.mark.parametrize("hb", HEADS_PER_BLOCK)
def test_shared_memory_fits(hb):
    """Every HB the planner can pick fits in a block's shared memory at
    mamba2-370m's prefill chunk (Q 64, N 128, P 64)."""
    assert smem_bytes_tc(64, 128, 64, hb) < SMEM_LIMIT


def _bf16_inputs(b, l, h, p, g, n, seed):
    """Numpy f32 inputs whose x, B and C are bf16 values."""
    rng = np.random.default_rng(seed)

    def bf(a):
        return torch.from_numpy(a.astype(np.float32)).bfloat16().float().numpy()
    x = bf(rng.standard_normal((b, l, h, p)) * 0.5)
    dt = np.log1p(np.exp(rng.standard_normal((b, l, h)) - 1.0)).astype(np.float32)
    a_log = (rng.standard_normal(h) * 0.3).astype(np.float32)
    bm = bf(rng.standard_normal((b, l, g, n)) * 0.5)
    cm = bf(rng.standard_normal((b, l, g, n)) * 0.5)
    return x, dt, a_log, bm, cm


# (B, L, H, P, G, N, chunk): mamba2-370m's widths, a few heads
TC_CASES = [(2, 32, 4, 64, 1, 128, 32), (1, 64, 3, 64, 1, 128, 64)]


@pytest.mark.parametrize("case", TC_CASES, ids=["decode_q32", "prefill_q64"])
def test_tc_numerics_match_reference_kernel(case):
    """The tensor-core body's roundings stay inside the kernel's tolerances
    against the JAX kernel (interpret mode) on bf16 x, B and C."""
    b, l, h, p, g, n, chunk = case
    x, dt, a_log, bm, cm = _bf16_inputs(b, l, h, p, g, n, seed=11)
    want = ssd_chunk_kernel(jnp.asarray(x, jnp.bfloat16), jnp.asarray(dt), jnp.asarray(a_log),
                            jnp.asarray(bm, jnp.bfloat16), jnp.asarray(cm, jnp.bfloat16),
                            chunk=chunk, interpret=True)
    t = torch.from_numpy
    got = ref.ssd_chunks_tc(t(x).bfloat16(), t(dt), t(a_log), t(bm).bfloat16(),
                            t(cm).bfloat16(), chunk)
    assert got[0].dtype == torch.bfloat16
    for name, gt, wt in zip(("y_intra", "contrib", "decay", "cs"), got, want):
        tol = 1e-2 if name == "y_intra" else 1e-4
        assert tuple(gt.shape) == wt.shape, name
        np.testing.assert_allclose(gt.float().numpy(), np.asarray(wt, np.float32), atol=tol,
                                   rtol=tol, err_msg=name)


def _y_rounded_once(x, dt, a_log, bmat, cmat, chunk):
    """y_intra with the decayed scores rounded to bf16 once: the design the
    tensor-core body does not take."""
    b, l, h, p = x.shape
    g, n = bmat.shape[2], bmat.shape[3]
    nc, hpg = l // chunk, h // g
    xr = x.float().reshape(b, nc, chunk, h, p)
    dtr = dt.reshape(b, nc, chunk, h)
    br, cr = (m.float().reshape(b, nc, chunk, g, n).repeat_interleave(hpg, dim=3)
              for m in (bmat, cmat))
    cs = torch.cumsum(dtr * -torch.exp(a_log), dim=2)
    tri = torch.ones(chunk, chunk, dtype=torch.bool).tril()
    decayed = (torch.einsum("bcqhn,bckhn->bcqkh", cr, br)
               * torch.exp(cs[:, :, :, None, :] - cs[:, :, None, :, :]) * dtr[:, :, None])
    left = torch.where(tri[:, :, None], decayed, 0.0).bfloat16().float()
    return torch.einsum("bcqkh,bckhp->bcqhp", left, xr).reshape(b, l, h, p).bfloat16()


def _excess(got, want, tol):
    """The largest |got - want| / (tol + tol |want|): over 1 fails the check."""
    want = want.float()
    return ((got.float() - want).abs() / (tol + tol * want.abs())).max().item()


# mamba2-370m's decode and prefill calls at full width: 4 slots, 32 heads
FULL_CASES = [(4, 32, 32, 64, 1, 128, 32), (4, 192, 32, 64, 1, 128, 64)]


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("case", FULL_CASES, ids=["decode_q32", "prefill_q64"])
def test_tc_numerics_at_full_width(case, seed):
    """At full width the mirror stays inside the card's check against the
    f32 chunk step (``ref.ssd_chunks``): 1e-2 on bf16 y_intra, 1e-4 on the
    rest; rounding y's scores once would not (seed 0 of the decode shape
    and of the prefill shape exceed it), which is why they are split too."""
    b, l, h, p, g, n, chunk = case
    x, dt, a_log, bm, cm = (torch.from_numpy(a) for a in _bf16_inputs(b, l, h, p, g, n, seed))
    args = (x.bfloat16(), dt, a_log, bm.bfloat16(), cm.bfloat16(), chunk)
    got = ref.ssd_chunks_tc(*args)
    want = ref.ssd_chunks(*args)
    for name, gt, wt in zip(("y_intra", "contrib", "decay", "cs"), got, want):
        assert _excess(gt, wt, 1e-2 if name == "y_intra" else 1e-4) <= 1.0, name
    # the split keeps contrib within 2^-16 of its scale; it does round
    scale = want[1].abs().max().item()
    assert 0 < (got[1] - want[1]).abs().max().item() <= 2.0 ** -16 * scale * 4
    assert torch.equal(got[2], want[2]) and torch.equal(got[3], want[3])
    if seed == 0:
        assert _excess(_y_rounded_once(*args), want[0], 1e-2) > 1.0
