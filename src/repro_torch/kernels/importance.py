"""Wrappers of the hand-written score kernel (``csrc/importance.cu``).

``importance`` is the counterpart of the reference's ``importance_kernel``
(paper Eq. 1), ``variation`` of its ``variation_kernel`` (the adaptive
cache's refresh priority).  One kernel computes both.  They take CUDA
tensors only; ``ops`` sends CPU tensors to the plain versions in ``ref``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _launch(fn, variation, h_new, h_old, conf, alpha, eps):
    """Checks, allocates the output, launches and counts the launch on ``fn``."""
    name = fn.__name__
    b, k, d = h_new.shape
    for arg, t in (("h_new", h_new), ("h_old", h_old), ("conf", conf)):
        if not t.is_cuda or t.device != h_new.device:
            raise ValueError(f"{name}: {arg} must be a CUDA tensor on {h_new.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous")
    if h_new.dtype not in _DTYPES or h_old.dtype != h_new.dtype:
        raise TypeError(f"{name}: h_new/h_old must share float32 or bfloat16, "
                        f"got {h_new.dtype}/{h_old.dtype}")
    if h_old.shape != h_new.shape or conf.shape != (b, k) or conf.dtype != torch.float32:
        raise ValueError(f"{name}: bad shapes {tuple(h_new.shape)} {tuple(h_old.shape)} "
                         f"conf {tuple(conf.shape)} {conf.dtype}")
    out = torch.empty((b, k), dtype=torch.float32, device=h_new.device)
    if b * k == 0:
        return out
    status = build.library().repro_importance(
        _DTYPES[h_new.dtype], int(variation), h_new.data_ptr(), h_old.data_ptr(),
        conf.data_ptr(), out.data_ptr(), b * k, d, float(alpha), float(eps),
        build.stream_ptr(h_new.device))
    build.check(status, name)
    fn.launches += 1
    return out


def importance(
    h_new: torch.Tensor,    # [B, K, d] float32 or bfloat16, contiguous
    h_old: torch.Tensor,    # [B, K, d] same dtype
    conf: torch.Tensor,     # [B, K] float32
    *,
    alpha: float,
    eps: float = 1e-8,
) -> torch.Tensor:
    """``alpha*conf + (1-alpha) * |Hn-Ho|_1 / (sqrt(d)*|Ho|_2 + eps)`` -> f32 [B, K]."""
    return _launch(importance, False, h_new, h_old, conf, alpha, eps)


importance.launches = 0


def variation(
    h_new: torch.Tensor,    # [B, T, d] float32 or bfloat16, contiguous
    h_old: torch.Tensor,    # [B, T, d] same dtype
    conf: torch.Tensor,     # [B, T] float32
    *,
    alpha: float,
    eps: float = 1e-8,
) -> torch.Tensor:
    """``alpha*conf + (1-alpha) * (1 - dot / (sqrt(|Hn|^2 |Ho|^2) + eps))`` -> f32 [B, T]."""
    return _launch(variation, True, h_new, h_old, conf, alpha, eps)


variation.launches = 0
