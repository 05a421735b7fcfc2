"""Checkpoint / resume (counterpart of ``qmps_tpu.utils.checkpoint``).

A checkpoint is a complete restart state: a nested tree of dicts, lists
and tuples whose leaves are tensors, arrays or scalars, saved atomically
as an npz with entries ``leaf_0 .. leaf_{n-1}`` and a JSON-encoded
structure ``__treedef__``.  The format is the JAX package's: dict keys
are flattened in sorted order, as ``jax.tree_util.tree_flatten`` does, so
a checkpoint written by either package loads in the other.
"""
from __future__ import annotations

import json
import os
import tempfile

import numpy as np
import torch


def _flatten(tree, leaves: list):
    """Append tree's leaves to ``leaves`` (dict keys sorted) and return
    its structure spec."""
    if isinstance(tree, dict):
        return {"__dict__": {k: _flatten(tree[k], leaves) for k in sorted(tree)}}
    if isinstance(tree, (list, tuple)):
        return {"__list__": [_flatten(v, leaves) for v in tree]}
    if isinstance(tree, torch.Tensor):
        tree = tree.detach().cpu().resolve_conj().numpy()
    leaves.append(np.asarray(tree))
    return "leaf"


def save_checkpoint(path: str, tree) -> None:
    """Atomically save a tree of tensors, arrays and scalars: written to a
    temporary file in the same directory, then renamed over ``path``."""
    leaves: list = []
    spec = _flatten(tree, leaves)
    payload = {f"leaf_{i}": leaf for i, leaf in enumerate(leaves)}
    payload["__treedef__"] = np.frombuffer(json.dumps(spec).encode(), dtype=np.uint8)
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".npz.tmp")
    os.close(fd)
    try:
        with open(tmp, "wb") as f:
            np.savez(f, **payload)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def _count_leaves(spec) -> int:
    if spec == "leaf":
        return 1
    if "__dict__" in spec:
        return sum(_count_leaves(v) for v in spec["__dict__"].values())
    return sum(_count_leaves(v) for v in spec["__list__"])


def _rebuild(spec, it):
    if spec == "leaf":
        return next(it)
    if "__dict__" in spec:
        return {k: _rebuild(v, it) for k, v in spec["__dict__"].items()}
    return [_rebuild(v, it) for v in spec["__list__"]]


def _rebuild_like(like, it):
    """``like``'s structure (dicts in sorted key order, lists and tuples
    kept as such) filled from the leaf iterator."""
    if isinstance(like, dict):
        filled = {k: _rebuild_like(like[k], it) for k in sorted(like)}
        return {k: filled[k] for k in like}
    if isinstance(like, (list, tuple)):
        return type(like)(_rebuild_like(v, it) for v in like)
    return next(it)


def load_checkpoint(path: str, like=None):
    """Load a checkpoint as CPU tensors: in ``like``'s structure when a
    template tree is given, else as the saved structure (dicts and lists)."""
    with np.load(path, allow_pickle=False) as z:
        spec = json.loads(bytes(z["__treedef__"]).decode())
        leaves = [torch.from_numpy(z[f"leaf_{i}"]) for i in range(_count_leaves(spec))]
    return _rebuild_like(like, iter(leaves)) if like is not None else _rebuild(spec, iter(leaves))
