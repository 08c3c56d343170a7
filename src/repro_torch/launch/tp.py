"""Tensor- and data-parallel runs on one host: ``world`` ranks, one process
each.

``spawn(fn, world, args, workdir=...)`` starts the ranks (``spawn`` start
method), joins them in a process group whose store is a file under
``workdir`` (no TCP port, so concurrent runs cannot collide), builds the
``(data, model)`` mesh (``mesh_shape``, ``(1, world)`` by default), calls
``fn(mesh, *args)`` on every rank and returns each rank's result.  Each
rank takes the caller's float32 matmul settings (TF32 on or off): a
spawned process starts from torch's defaults.  The backend is gloo by
default: it reduces CPU tensors, and CUDA tensors through the host, so
several ranks can share one card (NCCL refuses two ranks on one card);
with ``backend="nccl"`` each rank takes a card of its own.  Every rank runs the same engine on the same
inputs and reads the same summed values, so their results are equal.

``build_model`` makes the rank's shard of a model, from the reference's
parameter tree (``convert.params_from_numpy``) or from a seed (every full
leaf drawn from one generator, then cut), so TP-N weights are TP-1's.
"""
from __future__ import annotations

from pathlib import Path

import torch
import torch.distributed as dist


def spawn(fn, world: int, args: tuple = (), *, workdir, backend: str = "gloo",
          threads: int | None = None, mesh_shape: tuple[int, int] | None = None) -> list:
    """``[fn(mesh, *args) on rank r for r in range(world)]``; raises if a rank
    fails.  ``mesh_shape = (data, model)``, of ``world`` ranks."""
    import torch.multiprocessing as mp

    mesh_shape = tuple(mesh_shape or (1, world))
    if mesh_shape[0] * mesh_shape[1] != world:
        raise ValueError(f"a {mesh_shape} mesh over {world} ranks")
    precision = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
                 torch.get_float32_matmul_precision())
    workdir = Path(workdir)
    workdir.mkdir(parents=True, exist_ok=True)
    mp.start_processes(_rank_main, args=(world, fn, args, str(workdir), backend, threads,
                                         mesh_shape, precision),
                       nprocs=world, start_method="spawn")
    return [torch.load(workdir / f"rank{r}.pt", weights_only=False) for r in range(world)]


def _rank_main(rank: int, world: int, fn, args, workdir: str, backend: str, threads,
               mesh_shape: tuple, precision: tuple) -> None:
    from repro_torch.launch.mesh import make_debug_mesh

    torch.set_float32_matmul_precision(precision[2])
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = precision[:2]
    if threads:
        torch.set_num_threads(threads)
    if backend == "nccl":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    elif torch.cuda.is_available():
        torch.cuda.set_device(0)
    dist.init_process_group(backend, init_method=f"file://{workdir}/store", rank=rank,
                            world_size=world)
    try:
        mesh = make_debug_mesh(*mesh_shape, device_type="cuda" if backend == "nccl" else "cpu")
        torch.save(fn(mesh, *args), Path(workdir) / f"rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def build_model(cfg, mesh, device=None, *, tree=None, seed: int = 0, mode: str = "serve"):
    """The rank's shard of ``cfg``'s model on ``device`` (the card unless
    the caller asks for the CPU), cut by ``mode``'s rules: from the
    reference's numpy tree, or seeded random weights."""
    from repro_torch.convert import params_from_numpy
    from repro_torch.device import resolve_device
    from repro_torch.models import Model

    device = resolve_device(device)
    model = Model(cfg, device=device, mesh=mesh, mode=mode)
    if tree is not None:
        model.load_state_dict(params_from_numpy(tree, cfg, device, mesh=mesh, mode=mode))
    else:
        model.init(torch.Generator(device=device).manual_seed(seed))
    return model
