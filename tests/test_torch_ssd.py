"""The port's SSD scan (Mamba-2) against the JAX reference, on the CPU.

The reference runs its ``ssd_chunk_kernel`` in interpret mode and its XLA
lowering (``_ssd_chunks_xla``); the port runs ``ref.ssd_chunks``, the plain
version of its hand-written CUDA chunk kernel, and ``ops.ssd`` around it.
The same numpy inputs, made from a seed, go through both.  The cases are
those of ``tests/test_kernels_ssd.py`` (the second has two B/C groups and a
ragged L of 40 with chunk 16).  Float32 tolerance: 2e-5 abs + 2e-4 relative,
what the reference holds its own scan to against its sequential oracle (the
chunked form sums in another order); bf16 inputs 5e-2, as there.  The CUDA
kernel itself is held against ``ref.ssd_chunks`` by the ``cuda``-marked test
in ``test_torch_kernels.py`` and by ``chip_smoke.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.ssd_scan import ssd_chunk_kernel
from repro_torch.kernels import ops, ref
from repro_torch.kernels.ssd_scan import ssd_chunks

ATOL, RTOL = 2e-5, 2e-4
CASES = [
    # (B, L, H, P, G, N, chunk)
    (1, 16, 2, 8, 1, 4, 8),
    (2, 40, 4, 16, 2, 8, 16),     # ragged L vs chunk, two groups
    (1, 64, 8, 32, 1, 16, 64),    # single chunk
    (2, 33, 2, 16, 1, 8, 8),      # non-aligned L
]


def _inputs(case, seed=0):
    b, l, h, p, g, n, _ = case
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, l, h, p)).astype(np.float32) * 0.5
    dt = np.log1p(np.exp(rng.standard_normal((b, l, h)))).astype(np.float32)   # softplus
    a_log = (rng.standard_normal(h) * 0.3).astype(np.float32)
    bm = rng.standard_normal((b, l, g, n)).astype(np.float32) * 0.5
    cm = rng.standard_normal((b, l, g, n)).astype(np.float32) * 0.5
    return x, dt, a_log, bm, cm


def _padded(case, arrays):
    """The chunk ``ops.ssd`` picks and its zero padding of L to a multiple."""
    l, chunk = case[1], case[-1]
    ck = min(chunk, l) if l % min(chunk, l) == 0 else chunk
    pad = -l % ck
    x, dt, a_log, bm, cm = arrays
    x, dt, bm, cm = (np.pad(a, [(0, 0), (0, pad)] + [(0, 0)] * (a.ndim - 2))
                     for a in (x, dt, bm, cm))
    return ck, (x, dt, a_log, bm, cm)


def _close(got, want, atol=ATOL, rtol=RTOL, err_msg=""):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), atol=atol,
                               rtol=rtol, err_msg=err_msg)


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("impl", ["pallas", "xla"])
def test_chunks_match_reference_kernel(case, impl):
    """All four outputs of the chunk step, at the chunk and padding the scan
    uses: the JAX kernel in interpret mode, or its XLA mirror."""
    ck, arrays = _padded(case, _inputs(case))
    jin = tuple(jnp.asarray(a) for a in arrays)
    if impl == "pallas":
        want = ssd_chunk_kernel(*jin, chunk=ck, interpret=True)
    else:
        want = jops._ssd_chunks_xla(*jin, chunk=ck)
    got = ref.ssd_chunks(*(torch.from_numpy(a) for a in arrays), ck)
    for name, g, w in zip(("y_intra", "contrib", "decay", "cs"), got, want):
        assert tuple(g.shape) == w.shape and g.dtype == torch.float32, name
        _close(g, w, err_msg=name)


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("init", [False, True], ids=["zero_state", "init_state"])
def test_ssd_matches_reference_and_oracle(case, init):
    """``ops.ssd`` with and without ``init_state`` against the JAX ``ops.ssd``
    (its kernel in interpret mode) and the sequential oracle of both packages."""
    x, dt, a_log, bm, cm = _inputs(case, seed=1)
    b, _, h, p, _, n, chunk = case
    s0 = (np.random.default_rng(2).standard_normal((b, h, n, p)).astype(np.float32)
          if init else None)
    jin = tuple(jnp.asarray(a) for a in (x, dt, a_log, bm, cm))
    tin = tuple(torch.from_numpy(a) for a in (x, dt, a_log, bm, cm))
    js0 = None if s0 is None else jnp.asarray(s0)
    ts0 = None if s0 is None else torch.from_numpy(s0)
    y, s = ops.ssd(*tin, chunk=chunk, init_state=ts0)
    assert y.dtype == torch.float32 and tuple(s.shape) == (b, h, n, p)
    yj, sj = jops.ssd(*jin, chunk=chunk, init_state=js0, impl="pallas")
    _close(y, yj)
    _close(s, sj)
    yr, sr = jref.ssd_reference(*jin, init_state=js0)
    _close(y, yr)
    _close(s, sr)
    yt, st = ref.ssd_reference(*tin, init_state=ts0)
    _close(yt, yr)
    _close(st, sr)


def test_ssd_resume_from_state():
    """Decode property: scan(prefix) then scan(suffix | state) equals
    scan(full), the engine's block resume (tolerance as the reference's)."""
    x, dt, a_log, bm, cm = (torch.from_numpy(a) for a in _inputs((2, 32, 2, 8, 1, 4, 8)))
    y_full, s_full = ops.ssd(x, dt, a_log, bm, cm, chunk=8)
    _, s_pre = ops.ssd(x[:, :20], dt[:, :20], a_log, bm[:, :20], cm[:, :20], chunk=8)
    y_suf, s_end = ops.ssd(x[:, 20:], dt[:, 20:], a_log, bm[:, 20:], cm[:, 20:], chunk=8,
                           init_state=s_pre)
    _close(y_suf, y_full[:, 20:].numpy(), atol=3e-5, rtol=3e-4)
    _close(s_end, s_full.numpy(), atol=3e-5, rtol=3e-4)


def test_masked_decay_overflow_stays_finite():
    """With a steep decay, exp(cs_i - cs_j) of the masked i < j entries is
    inf: the chunk step must still give 0 there, as the reference's select
    does, and finite outputs equal to the JAX kernel's."""
    case = (1, 16, 2, 8, 1, 4, 16)
    x, dt, _, bm, cm = _inputs(case)
    dt = dt * 5.0 + 5.0
    a_log = np.full((2,), np.log(50.0), np.float32)          # A = -50
    arrays = (x, dt, a_log, bm, cm)
    got = ref.ssd_chunks(*(torch.from_numpy(a) for a in arrays), 16)
    want = ssd_chunk_kernel(*(jnp.asarray(a) for a in arrays), chunk=16, interpret=True)
    assert float(np.max(np.cumsum(dt[0, :, 0]) * 50.0)) > 200.0   # exp(+200) overflows f32
    for name, g, w in zip(("y_intra", "contrib", "decay", "cs"), got, want):
        assert torch.isfinite(g).all(), name
        _close(g, w, err_msg=name)


def test_ssd_bf16_matches_reference():
    """bf16 x, B and C: y in bf16, against the JAX scan with its kernel in
    interpret mode (tolerance 5e-2, as the reference holds bf16)."""
    case = (1, 32, 2, 16, 1, 8, 16)
    x, dt, a_log, bm, cm = _inputs(case, seed=3)
    jin = (jnp.asarray(x, jnp.bfloat16), jnp.asarray(dt), jnp.asarray(a_log),
           jnp.asarray(bm, jnp.bfloat16), jnp.asarray(cm, jnp.bfloat16))
    tin = (torch.from_numpy(x).bfloat16(), torch.from_numpy(dt), torch.from_numpy(a_log),
           torch.from_numpy(bm).bfloat16(), torch.from_numpy(cm).bfloat16())
    y, _ = ops.ssd(*tin, chunk=16)
    yj, _ = jops.ssd(*jin, chunk=16, impl="pallas")
    assert y.dtype == torch.bfloat16
    _close(y, np.asarray(yj, np.float32), atol=5e-2, rtol=5e-2)


def test_chunk_kernel_wrapper_refuses_cpu_tensors():
    """The wrapper launches its kernel or raises: it never computes on the CPU."""
    x, dt, a_log, bm, cm = (torch.from_numpy(a) for a in _inputs(CASES[0]))
    with pytest.raises(ValueError, match="CUDA"):
        ssd_chunks(x, dt, a_log, bm, cm, chunk=8)
    with pytest.raises(ValueError, match="multiple of chunk"):
        ref.ssd_chunks(x, dt, a_log, bm, cm, 5)
