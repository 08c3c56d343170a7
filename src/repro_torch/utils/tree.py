"""Small tree utilities of the port: nested dicts (and lists or tuples) of
tensors or numpy arrays, keyed as the reference's ``repro/utils/tree.py``
keys a pytree, so a checkpoint's flat keys are the same in both packages."""
from __future__ import annotations

from typing import Any, Iterable

import numpy as np
import torch


def flatten_with_paths(tree: Any) -> dict[str, Any]:
    """``{'a/b/0/c': leaf}`` in the reference's order: dict keys sorted (as
    JAX flattens a dict), sequence entries by index."""
    flat: dict[str, Any] = {}

    def walk(node, prefix: tuple) -> None:
        if isinstance(node, dict):
            items = ((str(k), node[k]) for k in sorted(node))
        elif isinstance(node, (list, tuple)):
            items = ((str(i), v) for i, v in enumerate(node))
        else:
            flat["/".join(prefix)] = node
            return
        for key, child in items:
            walk(child, prefix + (key,))

    walk(tree, ())
    return flat


def unflatten_paths(flat: dict[str, Any]) -> dict:
    """Nested dicts from ``{'a/b/c': leaf}`` (the inverse of
    :func:`flatten_with_paths` on a tree of dicts)."""
    tree: dict = {}
    for key, leaf in flat.items():
        *parents, last = key.split("/")
        node = tree
        for part in parents:
            node = node.setdefault(part, {})
        node[last] = leaf
    return tree


def _leaves(tree: Any) -> Iterable:
    return flatten_with_paths(tree).values()


def param_count(tree: Any) -> int:
    """Total number of scalar parameters in a tree."""
    return sum(int(np.prod(x.shape)) for x in _leaves(tree))


def global_norm(tree: Any) -> torch.Tensor:
    """The float32 l2 norm over every leaf of a tree of tensors."""
    return torch.sqrt(sum(torch.sum(torch.square(x.float())) for x in _leaves(tree)))
