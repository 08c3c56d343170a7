"""Wrapper of the hand-written SSD chunk kernel (``csrc/ssd_scan.cu``).

``ssd_chunks`` is the counterpart of the reference's ``ssd_chunk_kernel``
(Mamba-2): per (batch row, head, chunk) the intra-chunk output, the chunk's
state contribution, its total decay and the within-chunk cumsum.  It takes
CUDA tensors only; ``ops.ssd`` sends CPU tensors to ``ref.ssd_chunks`` and
does the padding and the recurrence across chunks.

Two kernel bodies compute the same function, and :func:`plan` picks one from
the arguments alone, the same way every time (no failure is caught):

* ``"tensor_core"``: bf16 x, B and C, a chunk of 16, 32, 48 or 64, N and P
  multiples of 16, x, B and C on 16-byte boundaries with 16-byte row
  strides.  One block per (chunk, batch row, ``heads_per_block`` heads of one
  B/C group), which share one C B^T; its numerics are ``ref.ssd_chunks_tc``.
* ``"cuda_core"``: everything else (f32, other chunks or widths, unaligned
  B/C views), one block per (batch row, head, chunk).

``ssd_chunks`` counts its launches (``launches``) and, beside them, the
launches of each body (``tensor_core_launches``, ``cuda_core_launches``).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.kernels import build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
SMEM_LIMIT = 232_448       # bytes of dynamic shared memory a block can have on sm_90
TC_CHUNKS = (16, 32, 48, 64)     # chunks the tensor-core body takes
# blocks of the tensor-core body resident at once: 256 threads at up to 128
# registers each take half an SM's registers
RESIDENT_BLOCKS = 2 * build.WAVE
HEADS_PER_BLOCK = (1, 2, 4, 8)   # what the planner picks from (a warp scans each head)


@dataclasses.dataclass(frozen=True)
class Plan:
    body: str                  # "tensor_core" or "cuda_core"
    heads_per_block: int = 1   # heads of one B/C group per block (tensor-core body)


def smem_bytes(chunk: int, n: int, p: int) -> int:
    """The CUDA-core body's shared memory: x*dt, B and C and the score tile
    (rows padded by one) and three per-position vectors, all f32."""
    return 4 * (chunk * p + 2 * chunk * (n + 1) + chunk * (chunk + 1) + 3 * chunk)


def smem_bytes_tc(chunk: int, n: int, p: int, heads_per_block: int) -> int:
    """The tensor-core body's shared memory: cs, dt and exp(cs_Q - cs) dt of
    each head (f32), B and C, and each head's x (bf16, rows padded by 8)."""
    hb = heads_per_block
    return 12 * hb * chunk + 2 * (2 * chunk * (n + 8) + hb * chunk * (p + 8))


def plan(x: torch.Tensor, bmat: torch.Tensor, chunk: int,
         cmat: torch.Tensor | None = None) -> Plan:
    """The body a call takes, and its heads per block, from the arguments
    alone.  The tensor-core body's heads per block: the fewest of
    ``HEADS_PER_BLOCK`` that divide the heads of a group and bring the grid
    within one wave of resident blocks (``RESIDENT_BLOCKS``), else the most
    that divide them.  Timed on the H100 (PERF.md): a second wave costs more
    than sharing B, C and C B^T saves, and below it fewer heads a block are
    faster (mamba2-370m: 1 at decode, 128 blocks; 2 at prefill, 192)."""
    b, l, h, p = x.shape
    g, n = bmat.shape[2], bmat.shape[3]
    if (x.dtype != torch.bfloat16 or bmat.dtype != torch.bfloat16 or chunk not in TC_CHUNKS
            or n % 16 or p % 16 or h % g
            or not all(build.aligned16(t) for t in (x, bmat, bmat if cmat is None else cmat))
            or smem_bytes_tc(chunk, n, p, 1) > SMEM_LIMIT):
        return Plan("cuda_core")
    blocks = b * (l // chunk) * h           # at one head a block
    fits = [c for c in HEADS_PER_BLOCK
            if (h // g) % c == 0 and smem_bytes_tc(chunk, n, p, c) <= SMEM_LIMIT]
    one_wave = [c for c in fits if blocks // c <= RESIDENT_BLOCKS]
    return Plan("tensor_core", one_wave[0] if one_wave else fits[-1])


def ssd_chunks(
    x: torch.Tensor,        # [B, L, H, P] float32 or bfloat16, contiguous
    dt: torch.Tensor,       # [B, L, H] float32, contiguous
    a_log: torch.Tensor,    # [H] float32
    bmat: torch.Tensor,     # [B, L, G, N] x's dtype; last two dims contiguous
    cmat: torch.Tensor,     # [B, L, G, N] as bmat, same strides
    *,
    chunk: int,
    heads_per_block: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns ``(y_intra [B, L, H, P] in x's dtype, contrib [B, nC, H, N, P],
    decay [B, nC, H], cs [B, L, H])``, the last three f32; ``L`` must be a
    multiple of ``chunk`` (``ops.ssd`` pads).  ``heads_per_block`` overrides
    the planner's for the tensor-core body (to time the choices); the body
    stays the planner's."""
    name = "ssd_chunks"
    build.refuse_grad(name, x, dt, a_log, bmat, cmat)
    for arg, t in (("x", x), ("dt", dt), ("a_log", a_log), ("bmat", bmat), ("cmat", cmat)):
        if not t.is_cuda or t.device != x.device:
            raise ValueError(f"{name}: {arg} must be a CUDA tensor on {x.device}")
    b, l, h, p = x.shape
    if bmat.dim() != 4 or bmat.shape[:2] != (b, l) or cmat.shape != bmat.shape:
        raise ValueError(f"{name}: B/C must be [B, L, G, N], got {tuple(bmat.shape)} "
                         f"{tuple(cmat.shape)} for x {tuple(x.shape)}")
    g, n = bmat.shape[2], bmat.shape[3]
    if dt.shape != (b, l, h) or a_log.shape != (h,) or h % g:
        raise ValueError(f"{name}: bad shapes dt {tuple(dt.shape)} a_log {tuple(a_log.shape)} "
                         f"for x {tuple(x.shape)} and {g} groups")
    if x.dtype not in _DTYPES or bmat.dtype != x.dtype or cmat.dtype != x.dtype:
        raise TypeError(f"{name}: x, B and C must share float32 or bfloat16, got "
                        f"{x.dtype}/{bmat.dtype}/{cmat.dtype}")
    if dt.dtype != torch.float32 or a_log.dtype != torch.float32:
        raise TypeError(f"{name}: dt and a_log must be float32")
    if not (x.is_contiguous() and dt.is_contiguous() and a_log.is_contiguous()):
        raise ValueError(f"{name}: x, dt and a_log must be contiguous")
    stride = bmat.stride()
    if (cmat.stride() != stride or stride[3] != 1 or stride[2] != n
            or (b > 1 and stride[0] != l * stride[1])):
        raise ValueError(f"{name}: B and C must share strides with contiguous [G, N] rows, "
                         f"got {stride} and {cmat.stride()}")
    if chunk <= 0 or l % chunk:
        raise ValueError(f"{name}: L={l} is not a multiple of chunk={chunk}")
    pl = plan(x, bmat, chunk, cmat)
    if pl.body == "cuda_core" and smem_bytes(chunk, n, p) > SMEM_LIMIT:
        raise ValueError(f"{name}: chunk {chunk}, N {n}, P {p} need "
                         f"{smem_bytes(chunk, n, p)} bytes of shared memory (> {SMEM_LIMIT})")
    hb = pl.heads_per_block if heads_per_block is None else heads_per_block
    if pl.body == "tensor_core" and ((h // g) % hb or smem_bytes_tc(chunk, n, p, hb)
                                     > SMEM_LIMIT):
        raise ValueError(f"{name}: {hb} heads a block do not divide the {h // g} heads of a "
                         f"group or do not fit in shared memory")
    nc = l // chunk
    f32 = dict(dtype=torch.float32, device=x.device)
    y = torch.empty_like(x)
    contrib = torch.empty((b, nc, h, n, p), **f32)
    decay = torch.empty((b, nc, h), **f32)
    cs = torch.empty((b, l, h), **f32)
    args = (x.data_ptr(), dt.data_ptr(), a_log.data_ptr(), bmat.data_ptr(), cmat.data_ptr(),
            stride[1], y.data_ptr(), contrib.data_ptr(), decay.data_ptr(), cs.data_ptr(), b, l,
            h, p, g, n, chunk)
    if pl.body == "tensor_core":
        status = build.library().repro_ssd_chunk_tc(*args, hb, build.stream_ptr(x.device))
        build.check(status, name)
        ssd_chunks.tensor_core_launches += 1
    else:
        status = build.library().repro_ssd_chunk(_DTYPES[x.dtype], *args,
                                                 build.stream_ptr(x.device))
        build.check(status, name)
        ssd_chunks.cuda_core_launches += 1
    ssd_chunks.launches += 1
    return y, contrib, decay, cs


ssd_chunks.launches = ssd_chunks.tensor_core_launches = ssd_chunks.cuda_core_launches = 0
