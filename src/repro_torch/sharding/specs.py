"""Sharding rules of the port, the counterpart of ``repro/sharding/specs.py``.

Meshes: single-pod ``(data=16, model=16)`` and multi-pod ``(pod=2, data=16,
model=16)`` (``launch/mesh.py``).  ``pod`` is pure data parallelism (batch
only); within a pod, training rules are 2-D FSDP x TP and serving rules pure
TP (params replicated over ``data``).

The rules are pure functions over ``(name, shape, mesh)``, where a mesh is a
``DeviceMesh``, a mapping of axis name to size, or anything with a
``shape`` mapping and ``axis_names`` (the reference tests' ``FakeMesh``).
A spec is a tuple with one entry per dim: ``None`` (replicated), an axis
name, a tuple of axis names (the dim cut over their product, the first axis
major), ``Grouped(axis, parts)`` or ``Leading(axis, n)`` (below).  An axis
the mesh does not have, or one that does not divide its dim, is dropped
(``_guard``), as in the reference.  ``local_slice`` cuts a rank's shard of
a full array.

The reference leaves the collectives to GSPMD, which regathers whatever its
flat rules cut; the port's tensor parallelism is explicit (whole heads,
whole ``d_ff`` columns, whole experts and whole SSM heads on each rank, one
sum after each row-parallel product), so its rules differ where a flat cut
would split a head or a group.  Every divergence, by name (``DIVERGENCES``):

=================  ========================  ==============================  ==============================
name               leaves                    reference                       port
=================  ========================  ==============================  ==============================
heads              ``wq``, ``wo``            flat split of ``H*Dh`` over     whole query heads: needs
                                             ``model`` where it divides,     ``n_heads % model == 0``, else
                                             mid-head too                    ``ValueError``
kv_heads           ``wk``, ``wv``, ``bk``,   flat split of ``Hkv*Dh``;       whole KV heads where
                   ``bv``; K/V cache planes  cache: ``H`` on ``model``       ``Hkv % model == 0``; where
                   and pools (and their      where it divides, else ``S``    ``model % Hkv == 0``,
                   int8 scales), cross       on ``model`` (dense); pools     ``Grouped(model, Hkv)``: each
                   planes                    replicate ``H``                 rank keeps the one KV head its
                                                                             query heads read (qwen2's 2,
                                                                             gemma3's 1, llama3's and the
                                                                             vision model's 8 at
                                                                             ``model=16``); else
                                                                             ``ValueError``
qkv_bias           ``bq``, ``bk``, ``bv``    replicated                      split with their heads
router             ``router``                experts column-split over       replicated: every rank routes
                                             ``model``                       the whole group, so capacity
                                                                             and drops agree on all ranks
long_context       dense K/V planes with     ``S`` over ``(data, model)``    the heads rule; ``B`` and
                   ``B == 1`` (long_500k)                                    ``S`` replicated
activations        ``hidden``, ``feat``      ``d`` on ``model``              replicated: each rank holds
                   state planes; the SSM                                     the summed hidden states
                   cache's ``ssmh``
ssm_heads          the mixer's ``z_proj``,   flat column split of the        whole SSM heads of
                   ``x_proj``, ``dt_proj``,  projections, the conv taps      ``headdim`` channels: needs
                   ``conv_x``, ``conv_xb``,  and ``out_proj``'s rows;        ``n_ssm_heads % model == 0``,
                   ``norm_scale``,           ``norm_scale``, ``a_log``,      else ``ValueError``; every
                   ``a_log``, ``dt_bias``,   ``dt_bias``, ``d_skip``         leaf of a head with it
                   ``d_skip``, ``out_proj``  replicated
ssm_groups         ``bc_proj``,              flat column split: at           replicated where
                   ``conv_bc``, ``conv_bcb`` ``model=2`` all of B on rank    ``n_groups == 1`` (every
                                             0, all of C on rank 1           rank's heads read the one
                                                                             group); ``n_groups > 1``
                                                                             raises ``ValueError``
ssm_conv_tail      the SSM cache's conv      flat split of ``conv_ch``       ``Leading(model, d_inner)``:
                   tail ``[G, B, W-1,        over ``model``                  the rank's ``d_inner / model``
                   conv_ch]``                                                x channels, then all ``2 G N``
                                                                             B/C channels
seq_parallel       training's residual       ``[B, L, d]`` constrained to    replicated over ``model``: each
                   stream between layer      ``L`` on ``model`` between      rank holds its batch rows'
                   groups                    groups (``act_sharding``,       whole hidden states
                                             ``seq_parallel_spec``)
=================  ========================  ==============================  ==============================

The attention rules need the head width (``head_dim``) and the SSM rules
the SSM config (``ssm``: its ``headdim`` and ``n_groups``); without them
the rules are the reference's flat ones.  The SSD state ``[G, B, H, N, P]``
keeps the reference's rule, heads on ``model``, and the cross planes follow
``kv_heads``; the vision model's ``enc_proj`` stays whole.

What runs: ``port_param_spec`` cuts every parameter (``Model._shard``,
``Model.init``, ``convert.params_from_numpy``) in serve mode, and in train
mode for training under FSDP x TP (``Model(mode="train")``:
``sharding/fsdp.py`` gathers the ``data`` pieces and reduce-scatters the
gradients); ``cache_leaf_spec`` shapes every K/V plane and pool, SSM plane
and cross plane (``Model.init_cache``) and ``batch_spec`` a rank's share of
the batch (``launch/steps.py``, the train step's rows).  The state specs
(``cache_pspecs``, ``block_state_pspecs``, ``engine_state_pspecs``) are the
layouts of record; ``tests/test_torch_sharding.py`` holds them to the
reference's.
"""
from __future__ import annotations

import dataclasses
import math
import re
from collections.abc import Mapping
from typing import Any, Optional

import numpy as np
import torch

_COL_PARALLEL = ("wq", "wk", "wv", "w_gate", "w_up", "in_proj", "router", "lm_head",
                 "z_proj", "x_proj", "bc_proj", "dt_proj")
_ROW_PARALLEL = ("wo", "w_down", "out_proj")
# attention leaves cut by whole heads (with head_dim): query side, KV side
_Q_LEAVES = ("wq", "bq", "wo")
_KV_LEAVES = ("wk", "wv", "bk", "bv")
# the mixer's leaves cut by whole SSM heads (with ssm), and those it replicates
_SSM_HEAD_LEAVES = ("z_proj", "x_proj", "dt_proj", "out_proj", "conv_x", "conv_xb",
                    "norm_scale", "a_log", "dt_bias", "d_skip")
_SSM_GROUP_LEAVES = ("bc_proj", "conv_bc", "conv_bcb")
# per-head leaves: one entry a head, not headdim channels
_SSM_PER_HEAD = ("dt_proj", "a_log", "dt_bias", "d_skip")

DIVERGENCES = {
    "heads": "wq/wo split by whole query heads; n_heads % model != 0 raises",
    "kv_heads": "wk/wv/bk/bv and the K/V planes split by whole KV heads, or "
                "Grouped(model, Hkv) where model % Hkv == 0; else raises",
    "qkv_bias": "bq/bk/bv split with their heads (the reference replicates them)",
    "router": "the MoE router replicated (the reference column-splits it)",
    "long_context": "a B == 1 dense K/V plane keeps the heads rule (the reference "
                    "cuts S over (data, model))",
    "activations": "hidden/feat state planes and ssmh replicated (the reference puts d on "
                   "model)",
    "ssm_heads": "the mixer's projections, conv taps, norm scale, per-head leaves and "
                 "out_proj split by whole SSM heads; n_ssm_heads % model != 0 raises",
    "ssm_groups": "bc_proj/conv_bc/conv_bcb replicated (n_groups == 1); n_groups > 1 raises",
    "ssm_conv_tail": "the SSM conv tail holds the rank's x channels, then every B/C channel",
    "seq_parallel": "training's [B, L, d] residual stream replicated over model (the reference "
                    "constrains L to model between groups)",
}


@dataclasses.dataclass(frozen=True)
class Grouped:
    """A dim cut into ``parts`` pieces over an axis of ``m`` ranks, ``m`` a
    multiple of ``parts``: the rank at coordinate ``c`` holds piece ``c *
    parts // m``, so each piece is held by ``m / parts`` ranks."""
    axis: str
    parts: int


@dataclasses.dataclass(frozen=True)
class Leading:
    """A dim whose first ``n`` entries are cut over ``axis`` (rank ``c`` of
    ``m`` holds entries ``[c n / m, (c + 1) n / m)``) and whose other entries
    every rank holds whole, after its piece: the SSM conv tail's x channels,
    then its B/C channels."""
    axis: str
    n: int


def axis_sizes(mesh) -> dict:
    """``{axis name: size}`` of a DeviceMesh, a mapping or a FakeMesh."""
    if mesh is None:
        return {}
    if isinstance(mesh, Mapping):
        return dict(mesh)
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return {n: mesh.size(i) for i, n in enumerate(names)}
    return dict(mesh.shape)


def dp_axes(mesh) -> tuple:
    """Batch-parallel axes: ('pod', 'data') on multi-pod, else ('data',)."""
    sizes = axis_sizes(mesh)
    return tuple(a for a in ("pod", "data") if a in sizes)


def _div(dim: int, sizes: dict, axis) -> bool:
    names = axis if isinstance(axis, tuple) else (axis,)
    return dim % math.prod(sizes.get(a, 1) for a in names) == 0


def _guard(spec: tuple, shape: tuple, mesh) -> tuple:
    """Drop any axis the mesh does not have, then any assignment that does
    not divide its dim (the reference's ``_guard``); ``Grouped`` entries
    and ``Leading`` entries were checked where they were made and stay."""
    sizes = axis_sizes(mesh)
    out = []
    for dim, axis in zip(shape, spec):
        if isinstance(axis, (Grouped, Leading)):
            out.append(axis if axis.axis in sizes else None)
            continue
        if axis is not None:
            names = tuple(n for n in (axis if isinstance(axis, tuple) else (axis,))
                          if n in sizes)
            axis = (names or None) if isinstance(axis, tuple) else (names[0] if names else None)
        out.append(axis if (axis is not None and _div(dim, sizes, axis)) else None)
    return tuple(out)


def leaf_name(path: str) -> str:
    """The last component of a reference (``a/b/c``) or port (``a.b.c``) path."""
    return re.split(r"[/.]", path)[-1]


def heads_axis(n_heads: int, mesh, *, kv: bool, what: str = "attention", ssm: bool = False):
    """The ``model`` entry of a dim of ``n_heads`` whole heads (SSM heads
    with ``ssm``): ``"model"`` where they divide, ``Grouped("model",
    n_heads)`` for KV heads that ``model`` is a multiple of, else
    ``ValueError``; None on a mesh without ``model``."""
    sizes = axis_sizes(mesh)
    if "model" not in sizes:
        return None
    m = sizes["model"]
    if n_heads % m == 0:
        return "model"
    if kv and m % n_heads == 0:
        return Grouped("model", n_heads)
    if kv:
        noun, need = "KV heads", "n_kv_heads % model == 0 or model % n_kv_heads == 0"
    else:
        noun = "SSM heads" if ssm else "heads"
        need = f"n_{'ssm_' if ssm else ''}heads % model == 0"
    raise ValueError(f"{what}: {n_heads} {noun} over model={m}; the port's tensor "
                     f"parallelism splits whole heads and needs {need}")


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------


def _ssm_spec(path: str, name: str, shape: tuple, mesh, fsdp, ssm) -> tuple:
    """The port's rule of a mixer leaf (``ssm_heads``, ``ssm_groups``)."""
    if name in _SSM_GROUP_LEAVES:
        if ssm.n_groups > 1 and axis_sizes(mesh).get("model", 1) > 1:
            raise ValueError(f"{path}: n_groups={ssm.n_groups}; the port's tensor "
                             f"parallelism replicates B and C, and cutting them by group is "
                             f"queued in ROADMAP.md (A8)")
        return ()
    width = shape[-2] if name == "out_proj" else shape[-1]
    per_head = 1 if name in _SSM_PER_HEAD else ssm.headdim
    if width % per_head:
        raise ValueError(f"{path}: width {width} is not whole SSM heads of {per_head}")
    heads = heads_axis(width // per_head, mesh, kv=False, what=path, ssm=True)
    lead = (None,) * (len(shape) - 2)
    if name == "out_proj":
        return _guard(lead + (heads, fsdp), shape, mesh)
    if name in ("z_proj", "x_proj", "dt_proj"):
        return _guard(lead + (fsdp, heads), shape, mesh)
    return _guard((None,) * (len(shape) - 1) + (heads,), shape, mesh)   # conv_x, 1-D leaves


def param_spec(path: str, shape: tuple, mesh, *, mode: str = "train",
               head_dim: int = 0, ssm=None) -> tuple:
    """mode='train': FSDP(data) x TP(model).  mode='serve': TP only.  Shapes
    are the reference's: layer leaves carry a leading group dim.  With
    ``head_dim`` and ``ssm`` (an ``SSMConfig``: ``headdim``, ``n_groups``)
    the port's rules (the divergences above: attention leaves by whole
    heads, the router replicated, mixer leaves by whole SSM heads, B and C
    whole); without them the reference's."""
    fsdp = "data" if mode == "train" else None
    name = leaf_name(path)
    shape = tuple(shape)

    if name == "embed":
        return _guard(("model", fsdp), shape, mesh)
    if ssm is not None and name in _SSM_HEAD_LEAVES + _SSM_GROUP_LEAVES:
        return _ssm_spec(path, name, shape, mesh, fsdp, ssm)
    if len(shape) <= 1:
        return ()
    lead = (None,) * (len(shape) - 2)

    if name in ("w_gate", "w_up") and len(shape) >= 4:        # MoE [.., E, d, f]
        return _guard((None,) * (len(shape) - 3) + ("model", fsdp, None), shape, mesh)
    if name == "w_down" and len(shape) >= 4:                  # MoE [.., E, f, d]
        return _guard((None,) * (len(shape) - 3) + ("model", None, fsdp), shape, mesh)

    if head_dim and name in _Q_LEAVES + _KV_LEAVES:
        width = shape[-2] if name == "wo" else shape[-1]
        if width % head_dim:
            raise ValueError(f"{path}: width {width} is not whole heads of {head_dim}")
        heads = heads_axis(width // head_dim, mesh, kv=name in _KV_LEAVES, what=path)
        if name in ("bq", "bk", "bv"):                        # [.., H*Dh]
            return _guard((None,) * (len(shape) - 1) + (heads,), shape, mesh)
        if name == "wo":
            return _guard(lead + (heads, fsdp), shape, mesh)
        return _guard(lead + (fsdp, heads), shape, mesh)
    if name == "router" and head_dim:
        return ()
    if name in _COL_PARALLEL:
        return _guard(lead + (fsdp, "model"), shape, mesh)
    if name in _ROW_PARALLEL:
        return _guard(lead + ("model", fsdp), shape, mesh)
    if name.startswith("conv_") and len(shape) >= 2:          # [.., W, C] depthwise
        return _guard(lead + (None, "model"), shape, mesh)
    # norm scales, biases, gates, dt params: replicate
    return ()


def port_param_spec(name: str, shape: tuple, mesh, head_dim: int, *,
                    mode: str = "serve", ssm=None) -> tuple:
    """:func:`param_spec` of a port parameter (``layers.3.attn.wq``): the
    port keeps its layers unstacked, so a layer leaf is ruled as the
    reference's ``[1, ...]`` leaf and the group dim dropped again."""
    kw = dict(mode=mode, head_dim=head_dim, ssm=ssm)
    if name.startswith(("layers.", "encoder.layers.")):
        return param_spec(name, (1,) + tuple(shape), mesh, **kw)[1:]
    return param_spec(name, shape, mesh, **kw)


# ---------------------------------------------------------------------------
# batches / activations
# ---------------------------------------------------------------------------


def batch_spec(shape: tuple, mesh) -> tuple:
    dp = dp_axes(mesh)
    return _guard((dp,) + (None,) * (len(shape) - 1), shape, mesh)


# ---------------------------------------------------------------------------
# caches
# ---------------------------------------------------------------------------


def cache_leaf_spec(kind: str, shape: tuple, mesh, *, paged: bool = False,
                    d_inner: int = 0) -> tuple:
    """kind in {'kv', 'cross', 'ssm', 'ssmh'}; shapes carry a leading
    layer dim.  ``paged=True``: the K/V leaves are page pools ``[G, P, ps,
    H, D]`` (scales ``[G, P, ps, H]``) shared by every slot, so pages stay
    replicated and only the heads are TP-sharded.  K/V and cross heads
    follow the ``kv_heads`` rule (and raise where it does).  The SSM conv
    tail's rule (``ssm_conv_tail``) needs the mixer's full ``d_inner``."""
    shape = tuple(shape)
    if kind == "ssmh":                       # [G, B, Lb, d]: activations
        return _guard((None, "data", None, None), shape, mesh)
    if kind == "ssm":
        if len(shape) == 5:                  # state [G, B, H, N, P]
            return _guard((None, "data", "model", None, None), shape, mesh)
        if len(shape) == 4:                  # conv tail [G, B, W-1, d_inner + 2GN]
            if not 0 < d_inner <= shape[3]:
                raise ValueError(f"the SSM conv tail {shape} needs its d_inner, not {d_inner}")
            m = axis_sizes(mesh).get("model", 1)
            if d_inner % m:
                raise ValueError(f"the SSM conv tail: d_inner {d_inner} over model={m}")
            return _guard((None, "data", None, Leading("model", d_inner)), shape, mesh)
        return ()
    if kind not in ("kv", "cross") or len(shape) not in (4, 5):
        return ()
    heads = heads_axis(shape[3], mesh, kv=True, what=f"{kind} cache")
    rest = (None,) * (len(shape) - 4)        # D of a plane, nothing of a scale plane
    if paged and kind == "kv":
        return _guard((None, None, None, heads) + rest, shape, mesh)
    return _guard((None, "data", None, heads) + rest, shape, mesh)


def cache_pspecs(cache: Any, mesh, *, paged: bool = False) -> Any:
    """The specs of a port cache (``KVCache``/``QuantKVCache``, ``SSMCache``,
    ``HybridCache``, ``EncDecCache``), in the same structure."""
    from repro_torch.models.attention import KVCache, QuantKVCache
    from repro_torch.models.mamba import SSMCache
    from repro_torch.models.model import EncDecCache, HybridCache

    def kv(c, kind="kv", pg=paged):
        return type(c)(*(cache_leaf_spec(kind, t.shape, mesh, paged=pg) for t in c))
    if cache is None:
        return None
    if isinstance(cache, (KVCache, QuantKVCache)):
        return kv(cache)
    if isinstance(cache, SSMCache):
        _, _, h, _, p = cache.state.shape
        return SSMCache(cache_leaf_spec("ssm", cache.state.shape, mesh),
                        cache_leaf_spec("ssm", cache.conv_tail.shape, mesh, d_inner=h * p),
                        cache_leaf_spec("ssmh", cache.ssmh.shape, mesh))
    if isinstance(cache, HybridCache):
        return HybridCache(kv(cache.kv), cache_pspecs(cache.ssm, mesh))
    if isinstance(cache, EncDecCache):
        return EncDecCache(None if cache.kv is None else kv(cache.kv),
                           kv(cache.cross, "cross", False))
    raise TypeError(f"not a port cache: {type(cache).__name__}")


def _activation_spec(shape: tuple, mesh) -> tuple:
    """``[B, T, d]`` hidden-state planes: slots on the batch axes, ``d``
    replicated (the ``activations`` divergence)."""
    return _guard((dp_axes(mesh), None, None), shape, mesh)


def block_state_pspecs(state: Any, mesh, *, paged: bool = False) -> Any:
    """Specs for ``core.engine.BlockState`` (the dry run's offline steps)."""
    from repro_torch.core.engine import BlockState

    opt = lambda t, f: None if t is None else f(t.shape, mesh)    # noqa: E731
    return BlockState(
        tokens=batch_spec(state.tokens.shape, mesh),
        cache=cache_pspecs(state.cache, mesh, paged=paged),
        conf=batch_spec(state.conf.shape, mesh),
        pred=batch_spec(state.pred.shape, mesh),
        hidden=tuple(_activation_spec(h.shape, mesh) for h in state.hidden),
        kv_valid=batch_spec(state.kv_valid.shape, mesh),
        t=(),
        feat=opt(state.feat, _activation_spec),
        conf_full=opt(state.conf_full, batch_spec),
        enc_out=opt(state.enc_out, batch_spec),
    )


def engine_state_pspecs(state: Any, mesh, *, paged: bool = False) -> Any:
    """Specs for ``core.engine.EngineState`` (the serving state): every
    per-slot ``[B]`` counter and the batch-leading buffers shard their slot
    dim over the batch axes, the sampling key is replicated, paged pools
    follow ``cache_leaf_spec(..., paged=True)``, and the block table shards
    its slot dim like every other per-slot vector."""
    from repro_torch.core.engine import EngineState

    dp = dp_axes(mesh)

    def slot_vec(t: Optional[Any]):
        return None if t is None else _guard((dp,), t.shape, mesh)

    def batch(t: Optional[Any]):
        return None if t is None else batch_spec(t.shape, mesh)
    return EngineState(
        tokens=batch(state.tokens),
        cache=cache_pspecs(state.cache, mesh, paged=paged),
        conf=batch(state.conf),
        pred=batch(state.pred),
        hidden=tuple(_activation_spec(h.shape, mesh) for h in state.hidden),
        kv_valid=batch(state.kv_valid),
        bs=slot_vec(state.bs),
        blocks_left=slot_vec(state.blocks_left),
        phase=slot_vec(state.phase),
        iters=slot_vec(state.iters),
        active=slot_vec(state.active),
        key=(),
        prompt_start=slot_vec(state.prompt_start),
        sample_seeds=slot_vec(state.sample_seeds),
        block_tables=batch(state.block_tables),
        feat=None if state.feat is None else _activation_spec(state.feat.shape, mesh),
        conf_full=batch(state.conf_full),
        cache_refreshed=slot_vec(state.cache_refreshed),
        cache_eligible=slot_vec(state.cache_eligible),
        poisoned=slot_vec(state.poisoned),
    )


# ---------------------------------------------------------------------------
# a rank's shard
# ---------------------------------------------------------------------------


def _dim_slice(dim: int, axis, sizes: dict, coords: dict) -> slice:
    if axis is None:
        return slice(None)
    if isinstance(axis, Grouped):
        piece, n = coords.get(axis.axis, 0) * axis.parts // sizes[axis.axis], axis.parts
    else:
        names = axis if isinstance(axis, tuple) else (axis,)
        piece, n = 0, 1
        for a in names:                      # the first axis major
            piece, n = piece * sizes[a] + coords.get(a, 0), n * sizes[a]
    if dim % n:
        raise ValueError(f"dim {dim} does not divide into {n} pieces")
    return slice(piece * (dim // n), (piece + 1) * (dim // n))


def local_shape(shape: tuple, spec: tuple, mesh) -> tuple:
    """The shape of one rank's shard."""
    sizes = axis_sizes(mesh)
    spec = tuple(spec) + (None,) * (len(shape) - len(spec))
    out = []
    for d, a in zip(shape, spec):
        if isinstance(a, Leading):
            s = _dim_slice(a.n, a.axis, sizes, {})
            out.append(s.stop - s.start + d - a.n)
            continue
        s = _dim_slice(d, a, sizes, {})
        out.append(d if a is None else s.stop - s.start)
    return tuple(out)


def local_index(shape: tuple, spec: tuple, mesh, coords: Mapping) -> tuple:
    """The index of the shard the rank at ``coords`` holds under ``spec`` in
    the full array (a spec without ``Leading`` dims)."""
    sizes = axis_sizes(mesh)
    spec = tuple(spec) + (None,) * (len(shape) - len(spec))
    return tuple(_dim_slice(d, a, sizes, coords) for d, a in zip(shape, spec))


def local_slice(full, spec: tuple, mesh, coords: Mapping):
    """The shard of ``full`` (a tensor or an array) that the rank at
    ``coords`` (``{axis: coordinate}``) holds under ``spec``: a view, or a
    copy where a dim is ``Leading``."""
    sizes = axis_sizes(mesh)
    spec = tuple(spec) + (None,) * (full.ndim - len(spec))
    out = full[tuple(slice(None) if isinstance(a, Leading) else _dim_slice(d, a, sizes, coords)
                     for d, a in zip(full.shape, spec))]
    for dim, a in enumerate(spec):
        if isinstance(a, Leading):
            head = (slice(None),) * dim
            parts = (out[head + (_dim_slice(a.n, a.axis, sizes, coords),)],
                     out[head + (slice(a.n, None),)])
            out = torch.cat(parts, dim) if torch.is_tensor(out) else np.concatenate(parts, dim)
    return out


def mesh_coords(mesh) -> dict:
    """``{axis: this rank's coordinate}`` of a DeviceMesh."""
    return dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))
