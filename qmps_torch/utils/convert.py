"""Carrying state across from the JAX package: its arrays (or any numpy
array-like) become this package's tensors on a chosen device and type;
its ``EvolveRecord``s, checkpoint trees, mixed-gauge triples and MPOs
become this package's."""
from __future__ import annotations

import numpy as np
import torch


def from_numpy(x, device="cpu", dtype: torch.dtype | None = None) -> torch.Tensor:
    """A numpy array or a JAX array (read through ``np.asarray``, which
    needs no JAX import here) -> a new tensor on ``device``, of ``dtype``
    (the array's own type if None).  Always a copy: a JAX array's host
    view is read-only."""
    return torch.tensor(np.asarray(x), device=device, dtype=dtype)


def from_tree(tree, device="cpu", dtype: torch.dtype | None = None):
    """A tree of dicts, lists and tuples (a checkpoint's, as
    ``utils.checkpoint`` saves them) with array or scalar leaves -> the
    same tree of tensors (``from_numpy`` on each leaf)."""
    if isinstance(tree, dict):
        return {k: from_tree(v, device, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(from_tree(v, device, dtype) for v in tree)
    return from_numpy(tree, device, dtype)


def from_evolve_record(rec, device="cpu", dtype: torch.dtype | None = None):
    """The JAX package's ``EvolveRecord`` (or anything with its four
    fields) -> ``qmps_torch.algorithms.evolve.EvolveRecord``."""
    from ..algorithms.evolve import EvolveRecord

    return EvolveRecord(**{f: from_numpy(getattr(rec, f), device, dtype)
                           for f in ("params", "loschmidt", "evs", "errors")})


def from_mixed_gauge(triple, device="cpu", dtype: torch.dtype | None = None):
    """A mixed-gauge triple (AL, AR, C) of the JAX package (its arrays, or
    numpy) -> a tuple of three tensors, as ``mps.tdvp.mixed_gauge``
    returns them."""
    return tuple(from_numpy(x, device, dtype) for x in triple)


def from_mpo(mpo):
    """The JAX package's ``MPO`` (or anything with a host ``W`` of shape
    (chi, chi, d, d)) -> ``qmps_torch.mps.mpo.MPO``, with the same checks
    of its Schur form."""
    from ..mps.mpo import MPO

    return MPO(np.asarray(mpo.W))
