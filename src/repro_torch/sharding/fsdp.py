"""The data-parallel layer of the port's training: FSDP over ``data`` beside
the tensor parallelism over ``model``, the counterpart of the reference's
``param_spec(mode="train")`` and ``train_state_pspecs`` under GSPMD.

A training model (``Model(cfg, mesh=..., mode="train")``) holds each leaf
as ``specs.port_param_spec(..., mode="train")`` cuts it: the tensor-parallel
cut, plus ``d`` on ``data`` where ``data`` divides it; the router, norms,
biases, conv taps and other 1-D leaves whole on ``data``, as the reference
keeps them; every leaf whole on ``pod``, which is pure data parallelism.
``named_parameters()`` keeps its names, and AdamW's moments are sized as
the shards.

Before a layer runs, :meth:`FSDP.gather` joins each of its leaves' ``data``
pieces into the rank's tensor-parallel shard (one ``all_gather``, site
``fsdp_gather``), inside the layer's checkpoint, so the remat's recompute
gathers again and nothing gathered lives between the forward and the
backward pass (FSDP's reshard after forward).  One autograd function does
it, and its backward returns the leaf's gradient:

* ``reduce_scatter`` by SUM over ``data`` (site ``fsdp_grad``), or, for a
  leaf whole on ``data``, an ``all_reduce`` over it (``dp_grad``);
* an ``all_reduce`` over ``pod`` (``pod_grad``);
* where several ranks of ``model`` hold one KV head (``Grouped``), an
  ``all_reduce`` over those ranks (``kv_heads``): each holds the gradient of
  its own query heads' reads.  This is *f* on K and V taken on the weights'
  side: *f* on the K/V activations would also count their path into the
  normed hidden states once for each such rank, where the *f* on the
  attention's input already sums it.

A leaf that nothing reduces (whole on both data axes, no ``Grouped`` entry)
reads as itself.  ``owner`` says whether this rank counts a leaf's shard
in a sum over the whole mesh (the gradient norm, the gathered tree): once
for each piece, whatever number of ranks hold it.

The same object holds the batch axes ``(pod, data)``: the rank's rows of
the global batch (:meth:`FSDP.rows`), and the sums and means over them
that the loss takes.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.distributed as dist

from repro_torch.sharding import specs
from repro_torch.sharding.comm import AxisGroup

_AXES = ("pod", "data", "model")


def _entry_axes(entry) -> tuple:
    """The axis names a spec entry cuts its dim over."""
    if entry is None:
        return ()
    if isinstance(entry, (specs.Grouped, specs.Leading)):
        return (entry.axis,)
    return entry if isinstance(entry, tuple) else (entry,)


class _Gather(torch.autograd.Function):
    """A leaf's ``data`` pieces joined (or the leaf itself), its gradient
    reduced over every rank that holds a copy of the leaf or a piece of it."""

    @staticmethod
    def forward(ctx, shard, fsdp: "FSDP", plan: tuple):
        ctx.fsdp, ctx.plan = fsdp, plan
        dim = plan[0]
        return shard.view_as(shard) if dim is None else fsdp.data.all_gather(shard, dim,
                                                                              "fsdp_gather")

    @staticmethod
    def backward(ctx, grad):
        fsdp, (dim, kv_parts) = ctx.fsdp, ctx.plan
        if dim is not None:
            grad = fsdp.data.reduce_scatter(grad, dim, "fsdp_grad")
        else:       # reduced in place below: a copy, not autograd's buffer
            grad = grad.contiguous().clone()
            if fsdp.data is not None:
                grad = fsdp.data._all_reduce(grad, "dp_grad")
        if fsdp.pod is not None:
            grad = fsdp.pod._all_reduce(grad, "pod_grad")
        if kv_parts:
            grad = fsdp.kv_group(kv_parts)._all_reduce(grad, "kv_heads")
        return grad, None, None


class FSDP:
    """The layout of a model's parameters over a mesh and the collectives of
    its training: ``layout[name] = (full shape, spec)`` for every leaf, the
    ``data`` and ``pod`` axes (None where the mesh has none or its size is
    1) and the subgroups of ``model`` that hold one KV head."""

    def __init__(self, mesh, layout: dict):
        self.mesh, self.layout = mesh, layout
        self.sizes, self.coords = specs.axis_sizes(mesh), specs.mesh_coords(mesh)
        self.data = AxisGroup.of(mesh, "data") if self.sizes.get("data", 1) > 1 else None
        self.pod = AxisGroup.of(mesh, "pod") if self.sizes.get("pod", 1) > 1 else None
        flat = 0
        for axis, size in self.sizes.items():
            flat = flat * size + self.coords[axis]
        if flat != dist.get_rank():
            raise ValueError(f"rank {dist.get_rank()} at {self.coords}: the port's meshes lay "
                             f"the process group's ranks out row-major (launch/mesh.py)")
        # the batch axes, (pod, data): piece batch_index of batch_size
        self.batch_axes = [g for g in (self.data, self.pod) if g is not None]
        self.batch_size = math.prod(g.size for g in self.batch_axes)
        self.batch_index = (self.coords.get("pod", 0) * self.sizes.get("data", 1)
                            + self.coords.get("data", 0))
        self._kv: dict = {}
        self._plans: dict = {}
        for name, (_, spec) in layout.items():
            dims = ([i for i, e in enumerate(spec) if "data" in _entry_axes(e)]
                    if self.data is not None else [])
            parts = [e.parts for e in spec if isinstance(e, specs.Grouped) and e.axis == "model"
                     and e.parts < self.sizes["model"]]
            self._plans[name] = (dims[0] if dims else None, parts[0] if parts else 0)
        self.cuts_data = any(p[0] is not None for p in self._plans.values())

    def rows(self, n: int) -> slice:
        """This rank's rows of a global batch of ``n`` (``specs.batch_spec``)."""
        if n % self.batch_size:
            raise ValueError(f"a global batch of {n} rows over {self.batch_size} data ranks")
        k = n // self.batch_size
        return slice(self.batch_index * k, (self.batch_index + 1) * k)

    def batch_sum(self, x: torch.Tensor, site: str) -> torch.Tensor:
        """The SUM of ``x`` over the batch axes, out of the graph."""
        x = x.detach().clone()
        for g in self.batch_axes:
            x = g.all_reduce_sum(x, site)
        return x

    def batch_mean(self, x: torch.Tensor, site: str) -> torch.Tensor:
        """*g*-mean: the mean of ``x`` over the batch axes, whose backward
        passes the gradient of the mean to each rank's own ``x``."""
        for g in self.batch_axes:
            x = g.all_reduce_sum(x, site)
        return x / self.batch_size

    def reduces(self) -> bool:
        """Whether a leaf's gradient is reduced over any ranks."""
        return (self.data is not None or self.pod is not None
                or any(p[1] for p in self._plans.values()))

    def active(self) -> bool:
        """Whether a pass must read the leaves through :meth:`gather`: some
        leaf is cut over ``data``, or a pass records a graph whose gradients
        some ranks reduce."""
        return self.cuts_data or (torch.is_grad_enabled() and self.reduces())

    def kv_group(self, parts: int) -> AxisGroup:
        """The ranks of this rank's ``model`` axis that hold the same one of
        ``parts`` pieces.  Every rank makes every such subgroup of the mesh,
        in one order (``new_group`` is a collective of the default group)."""
        if parts not in self._kv:
            m = self.sizes["model"]
            s = m // parts
            # the meshes of launch/mesh.py lay the default group's ranks out
            # row-major, model last: its rows are runs of m ranks
            mine = None
            for row in (list(range(i, i + m)) for i in range(0, dist.get_world_size(), m)):
                for piece in range(parts):
                    members = row[piece * s:(piece + 1) * s]
                    group = dist.new_group(members)
                    if dist.get_rank() in members:
                        mine = AxisGroup(group, members.index(dist.get_rank()), s)
            self._kv[parts] = mine
        return self._kv[parts]

    def gather(self, name: str, shard: torch.Tensor) -> torch.Tensor:
        """Leaf ``name`` as the rank's tensor-parallel shard: its ``data``
        pieces joined, through :class:`_Gather` where a gradient is
        recorded."""
        plan = self._plans[name]
        if torch.is_grad_enabled() and shard.requires_grad:
            if plan[1]:
                self.kv_group(plan[1])
            if plan[0] is not None or self.data is not None or self.pod is not None or plan[1]:
                return _Gather.apply(shard, self, plan)
            return shard
        if plan[0] is None:
            return shard
        return self.data.all_gather(shard, plan[0], "fsdp_gather")

    def owner(self, name: str) -> bool:
        """Whether this rank counts leaf ``name``'s shard once in a sum over
        the mesh: on every axis that does not cut the leaf its coordinate is
        0, and on a ``Grouped`` axis it is the first rank of its piece."""
        _, spec = self.layout[name]
        for axis in _AXES:
            if axis not in self.sizes:
                continue
            c = self.coords[axis]
            entries = [e for e in spec if axis in _entry_axes(e)]
            if not entries:
                if c:
                    return False
            elif isinstance(entries[0], specs.Grouped):
                if c % (self.sizes[axis] // entries[0].parts):
                    return False
        return True

    def grad_norm(self, grads: dict) -> torch.Tensor:
        """The f32 l2 norm of the whole gradient tree from each rank's
        shards' gradients ``{name: grad}``: the sums of squares of the
        leaves this rank owns (:meth:`owner`), in ``utils.tree``'s leaf
        order, summed over the mesh (site ``grad_norm``)."""
        sq = sum(torch.sum(torch.square(g.float())) for name, g in sorted(grads.items())
                 if self.owner(name))
        if not torch.is_tensor(sq):
            sq = torch.zeros((), dtype=torch.float32, device=next(iter(grads.values())).device)
        return torch.sqrt(self.world_sum(sq, "grad_norm"))

    def world_sum(self, x: torch.Tensor, site: str) -> torch.Tensor:
        """SUM ``all_reduce`` of ``x`` over every rank of the mesh (the
        default process group)."""
        return AxisGroup(None, dist.get_rank(), dist.get_world_size())._all_reduce(
            x.contiguous(), site)

    def full(self, name: str, shard: torch.Tensor) -> torch.Tensor:
        """The whole leaf ``name`` on every rank (a collective: every rank
        calls it), in f32: the owners write their shards into a zero buffer,
        which is summed over the mesh (exact: one owner writes each
        element)."""
        shape, spec = self.layout[name]
        out = torch.zeros(shape, dtype=torch.float32, device=shard.device)
        if self.owner(name):
            out[specs.local_index(shape, spec, self.sizes, self.coords)] = shard.float()
        return self.world_sum(out, "params")


class Gathered:
    """A module whose parameters read through :meth:`FSDP.gather`, each
    gathered once however often it is read (``p.wq.shape`` and ``p.wq``),
    and whose submodules read as such views too; every other attribute is
    the module's own."""

    def __init__(self, mod, prefix: str, fsdp: FSDP):
        self._mod, self._prefix, self._fsdp, self._leaves = mod, prefix, fsdp, {}

    def __getattr__(self, name: str):
        if name in self._leaves:
            return self._leaves[name]
        value = getattr(self._mod, name)
        if isinstance(value, torch.nn.Parameter):
            value = self._fsdp.gather(self._prefix + name, value)
        elif isinstance(value, torch.nn.Module):
            value = Gathered(value, f"{self._prefix}{name}.", self._fsdp)
        else:
            return value
        self._leaves[name] = value
        return value


def view(mod, prefix: str, fsdp: Optional[FSDP]):
    """``mod`` itself, or, where a pass must gather its leaves
    (:meth:`FSDP.active`), its :class:`Gathered` view; ``prefix`` is its
    name in the model (``layers.3.``)."""
    return mod if fsdp is None or not fsdp.active() else Gathered(mod, prefix, fsdp)
