"""Debug checks: a NaN/Inf scan of render outputs.

Counterpart of ``scan_finite`` in
``pathtracer_gaussiansplatting_tpu/utils/debug.py``, which the capture
runs under its ``debug_checks`` flag, so a scene that makes NaNs fails
loudly instead of writing them into the dataset. It walks dicts (in sorted
key order), lists, tuples, named tuples and dataclasses of tensors or
arrays as ``jax.tree_util`` does and names each leaf as ``keystr`` does,
so its message is the JAX package's. (The reference's ``checked``,
checkify around a jitted function, has no counterpart.)
"""
from __future__ import annotations

import dataclasses
from typing import Any, Iterator, Tuple

import numpy as np
import torch


def _leaves(tree: Any, path: str = "") -> Iterator[Tuple[str, Any]]:
    if tree is None:
        return
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{path}[{k!r}]")
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for name in tree._fields:
            yield from _leaves(getattr(tree, name), f"{path}.{name}")
    elif isinstance(tree, (list, tuple)):
        for i, x in enumerate(tree):
            yield from _leaves(x, f"{path}[{i}]")
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        for f in dataclasses.fields(tree):
            yield from _leaves(getattr(tree, f.name), f"{path}.{f.name}")
    else:
        yield path, tree


def _non_finite(leaf) -> Tuple[int, int]:
    """(non-finite count, size) of a floating leaf; (0, size) otherwise."""
    if isinstance(leaf, torch.Tensor):
        if not torch.is_floating_point(leaf):
            return 0, leaf.numel()
        return int((~torch.isfinite(leaf)).sum()), leaf.numel()
    arr = np.asarray(leaf)
    if not np.issubdtype(arr.dtype, np.floating):
        return 0, arr.size
    return int((~np.isfinite(arr)).sum()), arr.size


def scan_finite(tree: Any, context: str = "output") -> None:
    """Raise FloatingPointError if any floating leaf of ``tree`` holds a
    NaN or an Inf: "non-finite values in <context>: <leaf>: <bad>/<size>
    non-finite; ..."."""
    bad = []
    for path, leaf in _leaves(tree):
        n_bad, size = _non_finite(leaf)
        if n_bad:
            bad.append(f"{path}: {n_bad}/{size} non-finite")
    if bad:
        raise FloatingPointError(
            f"non-finite values in {context}: " + "; ".join(bad))
