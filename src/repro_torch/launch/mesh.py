"""Device meshes of the port, the counterpart of ``repro/launch/mesh.py``.

Each function returns a ``torch.distributed.device_mesh.DeviceMesh`` with the
reference's axis names, made by ``init_device_mesh`` over the default process
group.  The caller starts that group first, with its own address, world size
and rank (``torch.distributed.init_process_group``): NCCL with one rank a
card, gloo (CPU tests, or several ranks on one card), or a ``fake`` group of
the mesh's size for the dry run (``repro_torch.launch.dryrun``).  Functions,
not module-level constants, so importing this module touches no process
group.

The port uses the mesh's ``model`` axis for tensor parallelism.  Serving,
``data`` and ``pod`` are replicas, each serving its own share of the batch,
which exchange nothing; training cuts the parameters over ``data`` (FSDP,
``sharding/fsdp.py``) and sums the gradients over both.
"""
from __future__ import annotations

PRODUCTION_SHAPES = {False: ((16, 16), ("data", "model")),
                     True: ((2, 16, 16), ("pod", "data", "model"))}


def _mesh(shape, names, device_type: str):
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(device_type, tuple(shape), mesh_dim_names=tuple(names))


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda"):
    """``(data=16, model=16)``, or ``(pod=2, data=16, model=16)``."""
    return _mesh(*PRODUCTION_SHAPES[multi_pod], device_type)


def make_debug_mesh(data: int = 1, model: int = 1, *, device_type: str = "cuda"):
    """A small ``(data, model)`` mesh over the process group's ranks."""
    return _mesh((data, model), ("data", "model"), device_type)
