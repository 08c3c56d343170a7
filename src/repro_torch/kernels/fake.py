"""The kernel ops on fake tensors: the dry run's stand-ins.

Under ``FakeTensorMode`` (``launch/dryrun.py``) a tensor has a shape, a
dtype and a device but no data, so no kernel can launch.  Each op of
``ops`` that meets a ``FakeTensor`` comes here instead: it returns an empty
output of the kernel's shape (nothing for the in-place ones), touches no data
and no ctypes, and adds the kernel's work to ``TALLY``, counted as
``chip_smoke.py`` counts its bounds (``PERF.md`` §3): each input read once,
each output written once, 2 flops a multiply-add.  The counts that depend on
the data there (the K/V rows a mask admits, the rows a row or token mask
keeps) cannot be read from fake tensors, so every row is counted: an upper
bound of the same work.  Real tensors never come here: on the card they take
the kernel, on the CPU the plain version.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch._subclasses.fake_tensor import FakeTensor


class KernelTally:
    """Calls, flops and bytes by kernel since the last reset."""

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self.by_kernel: dict = {}

    def add(self, kernel: str, flops: float, nbytes: float) -> None:
        k = self.by_kernel.setdefault(kernel, {"calls": 0, "flops": 0.0, "bytes": 0.0})
        k["calls"] += 1
        k["flops"] += flops
        k["bytes"] += nbytes

    def total(self, key: str) -> float:
        return sum(k[key] for k in self.by_kernel.values())


TALLY = KernelTally()


def is_fake(*tensors: Optional[torch.Tensor]) -> bool:
    return any(isinstance(t, FakeTensor) for t in tensors)


def _bytes(*ts: Optional[torch.Tensor]) -> int:
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


def attention(q, k, v, q_pos, kv_pos, *, paged_rows: int = 0, k_scale=None, v_scale=None,
              block_tables=None) -> torch.Tensor:
    """Kernel 1 (or 2, with ``block_tables``): ``[B, Hq, Lq, D]`` in q's dtype.
    Every K/V row of the cache (each slot's ``n_vp * ps`` rows, paged) read
    once; ``4 Hq D`` flops per (query, key) pair."""
    b, hq, lq, d = q.shape
    lkv = kv_pos.shape[1]
    hkv = k.shape[1] if block_tables is None else k.shape[2]
    kv_rows = b * lkv
    kv_bytes = 2 * kv_rows * hkv * d * k.element_size()
    if k_scale is not None:
        kv_bytes += 2 * kv_rows * hkv * k_scale.element_size()
    out = q.new_empty(q.shape)
    TALLY.add("flash_attention" if block_tables is None else "paged_flash_attention",
              4.0 * b * hq * lq * lkv * d,
              _bytes(q, q_pos, kv_pos, block_tables, out) + kv_bytes)
    return out


def scatter(kernel: str, pairs, idx, *extra) -> None:
    """Kernels 3 and 4 (and the quantizing forms): each fresh row read once
    and written once, K and V; the indices, the table and the masks."""
    moved = 0
    for cache, new in pairs:
        moved += 2 * _bytes(new)
        if isinstance(cache, tuple):           # (codes, scales): codes and scales written
            codes, scales = cache
            moved += new.numel() * (codes.element_size() - new.element_size())
            moved += new.numel() // new.shape[-1] * scales.element_size()
    TALLY.add(kernel, 0.0, moved + _bytes(idx, *extra))


def fork_pages(k, v, src, dst, scales: bool = False) -> None:
    """Kernel 5: each real forked page read once and written once."""
    n = sum(int(s != d) for s, d in zip(src, dst))
    page = k[:, 0].numel() * k.element_size() + v[:, 0].numel() * v.element_size()
    TALLY.add("fork_pages_scales" if scales else "fork_pages", 0.0, 2.0 * n * page)


def score(kernel: str, h_new, h_old, conf, idx=None) -> torch.Tensor:
    """Kernels 6 and 7: f32 ``[B, K]``; ``h_new``, the rows of ``h_old`` and
    ``conf`` it scores read once (through ``idx``: ``K`` rows of each), three
    dot products of ``d`` a row."""
    b, kk, d = h_new.shape
    out = torch.empty((b, kk), dtype=torch.float32, device=h_new.device)
    read = 2 * _bytes(h_new) + b * kk * conf.element_size() + _bytes(idx, out)
    TALLY.add(kernel, 6.0 * b * kk * d, read)
    return out


def ssd_chunks(x, dt, a_log, bmat, cmat, chunk: int):
    """Kernel 8: ``(y_intra, contrib, decay, cs)`` of ``ref.ssd_chunks``'s
    shapes; ``C B^T`` and the two products with x per chunk."""
    b, l, h, p = x.shape
    n, nc = bmat.shape[3], l // chunk
    f32 = dict(dtype=torch.float32, device=x.device)
    outs = (x.new_empty(x.shape), torch.empty((b, nc, h, n, p), **f32),
            torch.empty((b, nc, h), **f32), torch.empty((b, l, h), **f32))
    flops = 2.0 * b * nc * h * (chunk * chunk * n + 2 * chunk * chunk * p + chunk * n * p)
    TALLY.add("ssd_chunks", flops, _bytes(x, dt, a_log, bmat, cmat, *outs))
    return outs
