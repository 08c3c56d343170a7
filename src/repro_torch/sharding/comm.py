"""The collectives of the port's tensor parallelism.

The reference has no such module: GSPMD inserts its collectives.  The port
places them by hand, in PyTorch's idiom: each rank's modules hold their
local shard, and every row-parallel output (attention's ``wo``, the MLP's
``w_down``, the MoE combine, the vocab-sharded embedding) is summed over the
mesh's ``model`` axis with one ``all_reduce``.  Logits of the vocab-sharded
head are gathered with a SUM ``all_reduce`` too (:meth:`TPGroup.gather_vocab`),
so one code path runs on gloo (the CPU, or several ranks on one card) and on
NCCL (one rank a card).

Every call is counted by kind and by site (``COUNTER``), which
``utils/collectives.py`` reads; with ``COUNTER.timing`` on, CUDA events
around each call on the card give the device time spent inside the
collectives.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist


class CollectiveCounter:
    """Calls and bytes of this process's collectives, by kind (the
    reference's ``all-reduce``) and by site (``embed``, ``attn``, ``mlp``,
    ``moe``, ``logits``)."""

    def __init__(self):
        self.timing = False
        self.reset()

    def reset(self) -> None:
        self.count_by_kind: dict = {}
        self.bytes_by_kind: dict = {}
        self.count_by_site: dict = {}
        self.bytes_by_site: dict = {}
        self._events: list = []

    def add(self, kind: str, site: str, nbytes: int) -> None:
        for counts, key in ((self.count_by_kind, kind), (self.count_by_site, site)):
            counts[key] = counts.get(key, 0) + 1
        for sizes, key in ((self.bytes_by_kind, kind), (self.bytes_by_site, site)):
            sizes[key] = sizes.get(key, 0) + nbytes

    def device_ms(self) -> float:
        """Device ms between the CUDA events around each timed call since the
        last reset (synchronizes)."""
        if not self._events:
            return 0.0
        torch.cuda.synchronize()
        return sum(a.elapsed_time(b) for a, b in self._events)


COUNTER = CollectiveCounter()


class TPGroup:
    """The ``model`` axis of a mesh: its process group, this rank's
    coordinate on it and its size."""

    def __init__(self, group, rank: int, size: int):
        self.group, self.rank, self.size = group, rank, size

    @classmethod
    def from_mesh(cls, mesh) -> Optional["TPGroup"]:
        """None without a mesh; a DeviceMesh must have a ``model`` axis."""
        if mesh is None:
            return None
        if "model" not in (mesh.mesh_dim_names or ()):
            raise ValueError(f"mesh axes {mesh.mesh_dim_names}: tensor parallelism runs "
                             f"over a 'model' axis")
        sub = mesh["model"]
        return cls(sub.get_group(), sub.get_local_rank(), sub.size())

    def all_reduce_sum(self, x: torch.Tensor, site: str) -> torch.Tensor:
        """The sum of ``x`` over the group's ranks (in place on a contiguous
        ``x``; use the result)."""
        x = x.contiguous()
        COUNTER.add("all-reduce", site, x.numel() * x.element_size())
        timed = COUNTER.timing and x.is_cuda
        if timed:
            ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
            ev[0].record()
        dist.all_reduce(x, op=dist.ReduceOp.SUM, group=self.group)
        if timed:
            ev[1].record()
            COUNTER._events.append(ev)
        return x

    def gather_vocab(self, local: torch.Tensor) -> torch.Tensor:
        """Full-vocab logits ``[..., size * V_l]`` from each rank's
        ``[..., V_l]`` slice: each rank writes its slice of a zero buffer,
        then the buffers are summed (exact: one slice is non-zero at each
        position)."""
        vl = local.shape[-1]
        full = local.new_zeros(local.shape[:-1] + (self.size * vl,))
        full[..., self.rank * vl:(self.rank + 1) * vl] = local
        return self.all_reduce_sum(full, "logits")


def tp_sum(tp: Optional[TPGroup], x: torch.Tensor, site: str) -> torch.Tensor:
    """``x`` summed over ``tp``'s ranks, or ``x`` itself without a group."""
    return x if tp is None else tp.all_reduce_sum(x, site)
