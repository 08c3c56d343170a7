"""Wrappers of the hand-written score kernel (``csrc/importance.cu``).

``importance`` is the counterpart of the reference's ``importance_kernel``
(paper Eq. 1), ``variation`` of its ``variation_kernel`` (the adaptive
cache's refresh priority).  One kernel computes both, one launch a call;
``importance`` also takes the skip stage's ``idx`` and reads the cached rows
and confidences through it, so the stage gathers nothing before it scores.
:func:`plan` gives the kernel its block shape.  They take CUDA tensors only;
``ops`` sends CPU tensors to the plain versions in ``ref``.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import torch

from repro_torch.kernels import build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
GROUPS = (32, 64, 128, 256)  # threads of a block, which scores one row (256: the launch bound)
LOADS = (1, 2, 4)           # 16-byte loads of each plane a thread may keep in flight


@dataclasses.dataclass(frozen=True)
class Plan:
    """A score launch's block shape: a block of ``group`` threads scores one
    row, each thread keeping ``loads`` 16-byte loads of each plane in flight
    (a row of more than ``group * loads`` vectors takes more trips)."""
    group: int
    loads: int


def _pow2(n: int) -> int:
    return 1 << max(0, n - 1).bit_length()


@functools.lru_cache(maxsize=256)
def plan(d: int, dtype: torch.dtype) -> Plan:
    """The block shape of a score over rows of ``d`` elements of ``dtype``:
    a thread for each 16-byte vector of a row up to 256 threads (at least a
    warp), then up to 4 loads a thread, so a row of up to 16 KB is in
    flight at once.  On the H100 (the block-shape sweep in PERF.md) more
    threads with fewer loads won or tied at every path shape,
    and reading through ``idx`` or not did not change the best shape."""
    if d <= 0 or dtype not in _DTYPES:
        raise ValueError(f"score plan: no block shape for d={d} {dtype}")
    vecs = -(-d * dtype.itemsize // 16)
    group = min(GROUPS[-1], max(GROUPS[0], _pow2(vecs)))
    return Plan(group, min(LOADS[-1], _pow2(-(-vecs // group))))


def _launch(fn, variation, h_new, h_old, conf, idx, alpha, eps):
    """Checks, allocates the output, launches and counts the launch on
    ``fn``.  The checks read each tensor's properties once: the skip stage
    calls this at every stage of every iteration."""
    name = fn.__name__
    build.refuse_grad(name, h_new, h_old, conf)
    card = h_new.get_device()                   # -1 off the card
    for arg, t in (("h_new", h_new), ("h_old", h_old), ("conf", conf), ("idx", idx)):
        if t is None:
            continue
        if card < 0 or t.get_device() != card:
            raise ValueError(f"{name}: {arg} must be a CUDA tensor on {h_new.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous")
    if h_new.dtype not in _DTYPES or h_old.dtype != h_new.dtype:
        raise TypeError(f"{name}: h_new/h_old must share float32 or bfloat16, "
                        f"got {h_new.dtype}/{h_old.dtype}")
    if h_new.dim() != 3:
        raise ValueError(f"{name}: h_new must be [B, K, d], got {tuple(h_new.shape)}")
    b, k, d = h_new.shape
    s = k if idx is None else (h_old.shape[1] if h_old.dim() == 3 else -1)
    if (h_old.shape != (b, s, d) or conf.shape != (b, s) or conf.dtype != torch.float32
            or (idx is not None and (idx.shape != (b, k) or idx.dtype != torch.int32))):
        raise ValueError(f"{name}: bad shapes h_new {tuple(h_new.shape)} h_old "
                         f"{tuple(h_old.shape)} conf {tuple(conf.shape)} {conf.dtype}"
                         + ("" if idx is None else f" idx {tuple(idx.shape)} {idx.dtype}"))
    out = torch.empty((b, k), dtype=torch.float32, device=h_new.device)
    if b * k == 0:
        return out
    pl = plan(d, h_new.dtype)
    status = build.library().repro_importance(
        _DTYPES[h_new.dtype], int(variation), h_new.data_ptr(), h_old.data_ptr(),
        conf.data_ptr(), None if idx is None else idx.data_ptr(), out.data_ptr(), b * k, d, k,
        s, float(alpha), float(eps), pl.group, pl.loads,
        build.stream_ptr(h_new.device))
    build.check(status, name)
    fn.launches += 1
    return out


def importance(
    h_new: torch.Tensor,    # [B, K, d] float32 or bfloat16, contiguous
    h_old: torch.Tensor,    # [B, K, d] same dtype; [B, S, d] with idx
    conf: torch.Tensor,     # [B, K] float32; [B, S] with idx
    *,
    alpha: float,
    eps: float = 1e-8,
    idx: Optional[torch.Tensor] = None,     # [B, K] int32
) -> torch.Tensor:
    """``alpha*conf + (1-alpha) * |Hn-Ho|_1 / (sqrt(d)*|Ho|_2 + eps)`` -> f32
    [B, K].  With ``idx``, row ``k`` of batch entry ``b`` reads
    ``h_old[b, idx[b, k]]`` and ``conf[b, idx[b, k]]``; an index outside
    ``[0, S)`` reads nothing and scores NaN."""
    return _launch(importance, False, h_new, h_old, conf, idx, alpha, eps)


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
    return _launch(variation, True, h_new, h_old, conf, None, alpha, eps)


variation.launches = 0
