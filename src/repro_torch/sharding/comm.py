"""The collectives of the port's tensor and data parallelism.

The reference has no such module: GSPMD inserts its collectives.  The port
places them by hand, in PyTorch's idiom: each rank's modules hold their
local shard, and every row-parallel output (attention's ``wo``, the MLP's
``w_down``, the MoE combine, the vocab-sharded embedding) is summed over the
mesh's ``model`` axis with one ``all_reduce``.  Logits of the vocab-sharded
head are gathered with a SUM ``all_reduce`` too (:meth:`TPGroup.gather_vocab`),
so one code path runs on gloo (the CPU, or several ranks on one card) and on
NCCL (one rank a card).

Training differentiates through them with Megatron's pair of functions:

* *g* (:meth:`AxisGroup.all_reduce_sum`): the SUM ``all_reduce`` of the
  forward, whose backward passes the gradient through unchanged (every rank
  computes the same loss, so the gradient reaching a sum is already the same
  on every rank);
* *f* (:meth:`AxisGroup.enter`): the identity in the forward, a SUM
  ``all_reduce`` of the gradient in the backward, wherever a value the ranks
  hold alike enters work that each rank does on its own part (its heads,
  columns, experts or SSM heads); counted at its own site, in the backward
  pass, so a pass without grad adds no collective.

The data axes (``data``, ``pod``) add the FSDP collectives
(``sharding/fsdp.py``): :meth:`AxisGroup.all_gather` of a parameter's
``data`` pieces before it is used, and :meth:`AxisGroup.reduce_scatter` of
its gradient (NCCL, and gloo on CPU and CUDA tensors).

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
    """Calls and result bytes of this process's collectives (the reference
    counts the result of each collective op), by kind (the
    reference's ``all-reduce``, ``all-gather``, ``reduce-scatter``), by site
    (``embed``, ``attn``, ``mlp``, ``moe``, ``logits``, ``attn_in``,
    ``fsdp_gather``, ...) and by both; with ``timing``, the device ms of
    each call on the card, by site."""

    def __init__(self):
        self.timing = False
        self.reset()

    def reset(self) -> None:
        self.count_by_kind: dict = {}
        self.bytes_by_kind: dict = {}
        self.count_by_site: dict = {}
        self.bytes_by_site: dict = {}
        self.count_by_kind_site: dict = {}
        self._events: list = []

    def add(self, kind: str, site: str, nbytes: int) -> None:
        for counts, key in ((self.count_by_kind, kind), (self.count_by_site, site)):
            counts[key] = counts.get(key, 0) + 1
        for sizes, key in ((self.bytes_by_kind, kind), (self.bytes_by_site, site)):
            sizes[key] = sizes.get(key, 0) + nbytes
        by_site = self.count_by_kind_site.setdefault(kind, {})
        by_site[site] = by_site.get(site, 0) + 1

    def device_ms(self) -> float:
        """Device ms between the CUDA events around each timed call since the
        last reset (synchronizes)."""
        return sum(self.device_ms_by_site().values())

    def device_ms_by_site(self) -> dict:
        """``{site: device ms}`` of the timed calls since the last reset
        (synchronizes)."""
        if not self._events:
            return {}
        torch.cuda.synchronize()
        out: dict = {}
        for site, a, b in self._events:
            out[site] = out.get(site, 0.0) + a.elapsed_time(b)
        return out


COUNTER = CollectiveCounter()


def _timed(x: torch.Tensor, site: str, call) -> None:
    """``call()``, between CUDA events when ``COUNTER.timing`` is on and
    ``x`` is on the card."""
    if not (COUNTER.timing and x.is_cuda):
        call()
        return
    ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
    ev[0].record()
    call()
    ev[1].record()
    COUNTER._events.append((site,) + ev)


class AxisGroup:
    """One axis of a mesh (or a subgroup of one): its process group, this
    rank's coordinate on it and its size."""

    def __init__(self, group, rank: int, size: int):
        self.group, self.rank, self.size = group, rank, size

    @classmethod
    def of(cls, mesh, axis: str) -> "AxisGroup":
        sub = mesh[axis]
        return cls(sub.get_group(), sub.get_local_rank(), sub.size())

    def _all_reduce(self, x: torch.Tensor, site: str) -> torch.Tensor:
        """In place on a contiguous ``x``: the SUM over the group."""
        COUNTER.add("all-reduce", site, x.numel() * x.element_size())
        _timed(x, site, lambda: dist.all_reduce(x, op=dist.ReduceOp.SUM, group=self.group))
        return x

    def all_reduce_sum(self, x: torch.Tensor, site: str) -> torch.Tensor:
        """*g*: the sum of ``x`` over the group's ranks (in place on a
        contiguous ``x``; use the result); in a pass that records a graph, a
        function whose backward passes the gradient through."""
        if torch.is_grad_enabled() and x.requires_grad:
            return _Sum.apply(x.contiguous(), self, site)
        return self._all_reduce(x.contiguous(), site)

    def enter(self, x: torch.Tensor, site: str) -> torch.Tensor:
        """*f*: ``x`` itself, whose gradient is summed over the group's
        ranks in the backward pass (no collective without grad)."""
        if torch.is_grad_enabled() and x.requires_grad:
            return _Enter.apply(x, self, site)
        return x

    def all_gather(self, x: torch.Tensor, dim: int, site: str) -> torch.Tensor:
        """The ranks' pieces of ``x`` joined along ``dim``, rank order."""
        n = self.size
        x = x.contiguous()
        COUNTER.add("all-gather", site, x.numel() * x.element_size() * n)
        shape = x.shape[:dim] + (n * x.shape[dim],) + x.shape[dim + 1:]
        flat = x.new_empty((n * x.shape[0],) + x.shape[1:])          # the ranks' x, dim 0
        _timed(x, site, lambda: dist.all_gather_into_tensor(flat, x, group=self.group))
        return flat.view((n,) + x.shape).movedim(0, dim).reshape(shape)

    def reduce_scatter(self, x: torch.Tensor, dim: int, site: str) -> torch.Tensor:
        """This rank's piece along ``dim`` of the SUM of ``x`` over the
        ranks."""
        n = self.size
        piece = x.shape[dim] // n
        parts = x.reshape(x.shape[:dim] + (n, piece) + x.shape[dim + 1:]).movedim(dim, 0)
        parts = parts.contiguous()
        COUNTER.add("reduce-scatter", site, parts[0].numel() * parts.element_size())
        out = x.new_empty(parts.shape[1:])
        flat = parts.view((n * parts.shape[1],) + parts.shape[2:])
        _timed(x, site, lambda: dist.reduce_scatter_tensor(out, flat, op=dist.ReduceOp.SUM,
                                                          group=self.group))
        return out


class _Sum(torch.autograd.Function):
    """*g*: SUM ``all_reduce`` forward, identity backward."""

    @staticmethod
    def forward(ctx, x, group: AxisGroup, site: str):
        ctx.mark_dirty(x)
        return group._all_reduce(x, site)

    @staticmethod
    def backward(ctx, grad):
        return grad, None, None


class _Enter(torch.autograd.Function):
    """*f*: identity forward, SUM ``all_reduce`` of the gradient backward."""

    @staticmethod
    def forward(ctx, x, group: AxisGroup, site: str):
        ctx.group, ctx.site = group, site
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return ctx.group._all_reduce(grad.contiguous().clone(), ctx.site), None, None


class TPGroup(AxisGroup):
    """The ``model`` axis of a mesh."""

    @classmethod
    def from_mesh(cls, mesh) -> Optional["TPGroup"]:
        """None without a mesh; a DeviceMesh must have a ``model`` axis."""
        if mesh is None:
            return None
        if "model" not in (mesh.mesh_dim_names or ()):
            raise ValueError(f"mesh axes {mesh.mesh_dim_names}: tensor parallelism runs "
                             f"over a 'model' axis")
        return cls.of(mesh, "model")

    def gather_vocab(self, local: torch.Tensor) -> torch.Tensor:
        """Full-vocab logits ``[..., size * V_l]`` from each rank's
        ``[..., V_l]`` slice: each rank writes its slice of a zero buffer,
        then the buffers are summed (exact: one slice is non-zero at each
        position)."""
        vl = local.shape[-1]
        full = local.new_zeros(local.shape[:-1] + (self.size * vl,))
        full[..., self.rank * vl:(self.rank + 1) * vl] = local
        return self.all_reduce_sum(full, "logits")


def tp_sum(tp: Optional[AxisGroup], x: torch.Tensor, site: str) -> torch.Tensor:
    """*g*: ``x`` summed over ``tp``'s ranks, or ``x`` itself without a group."""
    return x if tp is None else tp.all_reduce_sum(x, site)


def tp_enter(tp: Optional[AxisGroup], x: torch.Tensor, site: str) -> torch.Tensor:
    """*f*: ``x``, its gradient summed over ``tp``'s ranks (``x`` itself
    without a group)."""
    return x if tp is None else tp.enter(x, site)
