"""Flat-npz checkpoints in the reference's format (``repro/train/
checkpoint.py``): the parameter tree restacked to the reference's layout
(``convert.params_to_numpy``), keyed by path (``"layers/0/attn/wq"``), with
``__step__``.  A file written by either package loads into the other.  A
model with a mesh saves from every rank (the tree is gathered, a
collective) and rank 0 writes the file; it restores by cutting the tree
back to each rank's shards."""
from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from repro_torch.convert import params_from_numpy, params_to_numpy, restack
from repro_torch.models.model import Model
from repro_torch.utils.tree import flatten_with_paths, unflatten_paths


def save_checkpoint(path: str, model: Model, *, step: Optional[int] = None) -> None:
    """Writes ``path`` through ``path + ".tmp"`` and an atomic rename (rank
    0's, on a model with a mesh: every rank calls it)."""
    arrays = flatten_with_paths(params_to_numpy(model))
    if model.fsdp is not None and torch.distributed.get_rank() != 0:
        torch.distributed.barrier()           # rank 0 has written the file
        return
    if step is not None:
        arrays["__step__"] = np.asarray(step)
    tmp = path + ".tmp"
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
    os.replace(tmp, path)
    if model.fsdp is not None:
        torch.distributed.barrier()


def restore_checkpoint(path: str, model: Model) -> Optional[int]:
    """Loads ``path`` into ``model``'s parameters in place and returns the
    saved step (None if the file has none).  Raises ``KeyError`` naming the
    first missing keys, as the reference does."""
    want = flatten_with_paths(restack(model, lambda name: np.zeros(())))
    with np.load(path) as data:
        step = int(data["__step__"]) if "__step__" in data else None
        missing = [k for k in want if k not in data]
        if missing:
            raise KeyError(f"checkpoint missing keys: {missing[:5]} ...")
        tree = unflatten_paths({k: data[k] for k in want})
    model.load_state_dict(params_from_numpy(tree, model.cfg, model.device,
                                            mesh=None if model.fsdp is None else model.fsdp.mesh,
                                            mode=model.mode))
    return step
