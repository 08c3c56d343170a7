"""Wrapper of the hand-written SSD chunk kernel (``csrc/ssd_scan.cu``).

``ssd_chunks`` is the counterpart of the reference's ``ssd_chunk_kernel``
(Mamba-2): per (batch row, head, chunk) the intra-chunk output, the chunk's
state contribution, its total decay and the within-chunk cumsum.  It takes
CUDA tensors only; ``ops.ssd`` sends CPU tensors to ``ref.ssd_chunks`` and
does the padding and the recurrence across chunks.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
SMEM_LIMIT = 232_448       # bytes of dynamic shared memory a block can have on sm_90


def smem_bytes(chunk: int, n: int, p: int) -> int:
    """The kernel's shared memory: x*dt, B and C and the score tile (rows
    padded by one) and three per-position vectors, all f32."""
    return 4 * (chunk * p + 2 * chunk * (n + 1) + chunk * (chunk + 1) + 3 * chunk)


def ssd_chunks(
    x: torch.Tensor,        # [B, L, H, P] float32 or bfloat16, contiguous
    dt: torch.Tensor,       # [B, L, H] float32, contiguous
    a_log: torch.Tensor,    # [H] float32
    bmat: torch.Tensor,     # [B, L, G, N] x's dtype; last two dims contiguous
    cmat: torch.Tensor,     # [B, L, G, N] as bmat, same strides
    *,
    chunk: int,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns ``(y_intra [B, L, H, P] in x's dtype, contrib [B, nC, H, N, P],
    decay [B, nC, H], cs [B, L, H])``, the last three f32; ``L`` must be a
    multiple of ``chunk`` (``ops.ssd`` pads)."""
    name = "ssd_chunks"
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
    if smem_bytes(chunk, n, p) > SMEM_LIMIT:
        raise ValueError(f"{name}: chunk {chunk}, N {n}, P {p} need "
                         f"{smem_bytes(chunk, n, p)} bytes of shared memory (> {SMEM_LIMIT})")
    nc = l // chunk
    f32 = dict(dtype=torch.float32, device=x.device)
    y = torch.empty_like(x)
    contrib = torch.empty((b, nc, h, n, p), **f32)
    decay = torch.empty((b, nc, h), **f32)
    cs = torch.empty((b, l, h), **f32)
    status = build.library().repro_ssd_chunk(
        _DTYPES[x.dtype], x.data_ptr(), dt.data_ptr(), a_log.data_ptr(), bmat.data_ptr(),
        cmat.data_ptr(), stride[1], y.data_ptr(), contrib.data_ptr(), decay.data_ptr(),
        cs.data_ptr(), b, l, h, p, g, n, chunk, build.stream_ptr(x.device))
    build.check(status, name)
    ssd_chunks.launches += 1
    return y, contrib, decay, cs


ssd_chunks.launches = 0
