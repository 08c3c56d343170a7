"""Dry run of the port's tensor-parallel steps on the production meshes, the
counterpart of ``repro/launch/dryrun.py``: for every (architecture x input
shape), per-rank memory, FLOPs, bytes and collectives of one step.

The reference lowers and compiles each step for 256 or 512 fake XLA
devices.  The port runs its own step, the code the card runs, as rank 0 of
a ``fake`` process group of the mesh's size, under ``FakeTensorMode``:
model, state and inputs are fake tensors (shapes, no data) on a fake
``cuda`` device, so one CPU process needs neither a card nor the memory.
The kernel ops return empty outputs and tally their work
(``kernels/fake.py``); the collectives run on the fake group and are
counted.  Each JSON holds the reference's keys:

  flops           ``FlopCounterMode``'s matmul FLOPs + the kernels' tallied FLOPs
  bytes_accessed  operands and results of every other op, unfused, + the
                  kernels' tallied bytes
  collectives     ``CollectiveStats.as_dict()`` (``utils/collectives.py``)
  memory          ``argument_size``: the bytes of this rank's parameters and
                  step state, exact; ``output_size``: the step's new outputs;
                  ``temp_size``: the live-bytes peak of the step above
                  ``argument_size``, from ``MemTracker``
                  (``torch.distributed._tools.mem_tracker``) over the fake
                  tensors
  timing          ``build_s`` (model, engine and state), ``step_s``

A torch built without CUDA cannot index a fake ``cuda`` tensor (its Python
indexing takes a CUDA device guard that the build lacks), so there the fake
tensors sit on the CPU device (``fake_device`` in the JSON): shapes, bytes
and FLOPs are the same.  A combination the port refuses (training, head
counts the mesh does not divide) is written with its ``unsupported``
reason.

Every serving combination runs pure TP: each rank holds ``1/model`` of the
weights.  The reference switches to FSDP x TP weights where a rank's share
passes 4 GiB (jamba-v0.1-52b's 6.5 GiB, sized for v5e's 16 GiB); the port
does not, and records jamba-v0.1-52b's per-rank ``argument_size`` as it is.
``train_4k`` runs the train step under FSDP x TP (``launch/steps.py``):
forward, backward and AdamW on the rank's shards and rows, its collectives
by kind (``all-gather``, ``reduce-scatter``, ``all-reduce``) and site.  The
reference's ``--variant`` flag (``int8kv``, ``ssm_seqpar``, ``moe_lean``) is
not ported (``ROADMAP.md``, A8).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llada-8b --shape decode_32k --mesh single
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--shape train_4k] [--mesh single|multi|both]

Results go to ``build/dryrun/<arch>__<shape>__<mesh>.json`` at the repo
root; an existing one is kept unless ``--force``.
"""
from __future__ import annotations

import argparse
import json
import math
import time
import traceback
from pathlib import Path

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.configs import INPUT_SHAPES, list_archs
from repro_torch.kernels.fake import TALLY
from repro_torch.launch import steps as step_lib
from repro_torch.launch.mesh import PRODUCTION_SHAPES, make_debug_mesh, make_production_mesh
from repro_torch.sharding.comm import COUNTER
from repro_torch.utils.collectives import collective_stats, cost_dict

ARTIFACT_DIR = Path(__file__).resolve().parents[3] / "build" / "dryrun"


def fake_device() -> str:
    return "cuda" if torch.version.cuda else "cpu"


def start_group(world: int) -> None:
    """Rank 0 of a ``fake`` process group of ``world`` ranks (restarted if
    another group is up)."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        if dist.get_backend() == "fake" and dist.get_world_size() == world:
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)


def tensors_of(tree) -> list:
    return [t for t in torch.utils._pytree.tree_leaves(tree) if torch.is_tensor(t)]


def nbytes(ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


class OpBytes(TorchDispatchMode):
    """Operand and result bytes of every op that makes a tensor, but views,
    metadata queries, the kernels' stand-ins (tallied by ``kernels/fake.py``)
    and the collectives."""

    def __init__(self):
        super().__init__()
        self.bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not (func.is_view or func.namespace in ("c10d", "prim")) and tensors_of(out):
            self.bytes += nbytes(tensors_of((args, kwargs, out)))
        return out


def make_mesh(mesh_name: str, debug: tuple | None = None):
    """``single``/``multi``, or a ``(data, model)`` debug mesh."""
    if debug is not None:
        start_group(math.prod(debug))
        return make_debug_mesh(*debug, device_type=fake_device())
    shape, _ = PRODUCTION_SHAPES[mesh_name == "multi"]
    start_group(math.prod(shape))
    return make_production_mesh(multi_pod=mesh_name == "multi", device_type=fake_device())


def run_one(arch: str, shape_name: str, mesh_name: str, *, verbose: bool = True,
            debug: tuple | None = None, **overrides) -> dict:
    """One combination's record; ``debug=(data, model)`` takes a debug mesh,
    and ``overrides`` (``cfg``, ``shape``, ``gen``, ``ce_chunk``) reach
    ``steps.input_specs``."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed._tools.mem_tracker import MemTracker
    from torch.distributed.tensor.debug import CommDebugMode
    from torch.utils.flop_counter import FlopCounterMode

    shape = overrides.get("shape") or INPUT_SHAPES[shape_name]
    mesh = make_mesh(mesh_name, debug)
    n_chips = mesh.size()
    result = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
              "n_chips": n_chips, "kind": shape.kind, "fake_device": fake_device(),
              "mesh_shape": dict(zip(mesh.mesh_dim_names, mesh.shape))}
    mode = FakeTensorMode()
    t0 = time.perf_counter()
    try:
        with mode:
            step, args, model = step_lib.input_specs(arch, shape_name, mesh,
                                                     device=fake_device(), **overrides)
    except (NotImplementedError, ValueError) as e:
        result["unsupported"] = str(e)
        if verbose:
            print(f"[dryrun] {arch:24s} {shape_name:12s} {mesh_name:6s} unsupported: {e}")
        return result
    t_build = time.perf_counter() - t0
    params, arg_tensors = list(model.parameters()), tensors_of(args)
    argument_size = nbytes(params) + nbytes(arg_tensors)
    COUNTER.reset()
    TALLY.reset()
    with mode:
        tracker = MemTracker()
        tracker.track_external(model, *arg_tensors)
        t0 = time.perf_counter()
        with tracker, FlopCounterMode(display=False) as flops, CommDebugMode() as comm, \
                OpBytes() as op_bytes:
            out = step(*args)
        t_step = time.perf_counter() - t0
    peak = sum(snap["Total"] for snap in tracker.get_tracker_snapshot("peak").values())
    inputs = {t.untyped_storage()._cdata for t in params + arg_tensors}
    fresh = {t.untyped_storage()._cdata: t for t in tensors_of(out)
             if t.untyped_storage()._cdata not in inputs}
    cost = cost_dict(flops, TALLY, op_bytes.bytes)
    coll = collective_stats(COUNTER, comm)
    result.update({
        "flops": cost["flops"],
        "bytes_accessed": cost["bytes accessed"],
        "collectives": coll.as_dict(),
        "collectives_by_site": {"count": dict(COUNTER.count_by_site),
                                "bytes": dict(COUNTER.bytes_by_site),
                                "count_by_kind": {k: dict(v) for k, v in
                                                  COUNTER.count_by_kind_site.items()}},
        "kernels": {k: dict(v) for k, v in TALLY.by_kernel.items()},
        "memory": {"argument_size": argument_size,
                   "output_size": nbytes(fresh.values()),
                   "temp_size": max(int(peak) - argument_size, 0),
                   "generated_code_size": 0},
        "local_batch": step_lib.local_batch(shape, mesh),
        "timing": {"build_s": round(t_build, 2), "step_s": round(t_step, 2)},
    })
    if verbose:
        print(f"[dryrun] {arch:24s} {shape_name:12s} {mesh_name:6s} chips={n_chips:4d} "
              f"flops={result['flops']:.3e} bytes={result['bytes_accessed']:.3e} "
              f"coll={coll.total_bytes:.3e}B/{coll.total_count} "
              f"argmem/dev={argument_size / 2**30:.2f}GiB "
              f"temp/dev={result['memory']['temp_size'] / 2**30:.2f}GiB "
              f"(build {t_build:.1f}s step {t_step:.1f}s)")
    return result


def artifact_path(arch: str, shape: str, mesh_name: str) -> Path:
    return ARTIFACT_DIR / f"{arch}__{shape}__{mesh_name}.json"


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(INPUT_SHAPES) + [None])
    ap.add_argument("--mesh", default="both", choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true")
    args = ap.parse_args(argv)

    archs = list_archs() if (args.all or args.arch is None) else [args.arch]
    shapes = list(INPUT_SHAPES) if args.shape is None else [args.shape]
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]

    ARTIFACT_DIR.mkdir(parents=True, exist_ok=True)
    failures = []
    for arch in archs:
        for shape in shapes:
            for mesh_name in meshes:
                path = artifact_path(arch, shape, mesh_name)
                if path.exists() and not args.force:
                    print(f"[dryrun] skip (cached): {path.name}")
                    continue
                try:
                    result = run_one(arch, shape, mesh_name)
                    path.write_text(json.dumps(result, indent=1))
                except Exception as e:  # noqa: BLE001
                    failures.append((arch, shape, mesh_name, repr(e)))
                    traceback.print_exc()
    if dist.is_initialized():
        dist.destroy_process_group()
    if failures:
        print("\nFAILURES:")
        for f in failures:
            print(" ", f)
        raise SystemExit(1)
    print("\nEvery dry-run combination ran or was refused with its reason.")


if __name__ == "__main__":
    main()
