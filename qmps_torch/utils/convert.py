"""Carrying state across from the JAX package: its arrays (or any numpy
array-like) become this package's tensors on a chosen device and type."""
from __future__ import annotations

import numpy as np
import torch


def from_numpy(x, device="cpu", dtype: torch.dtype | None = None) -> torch.Tensor:
    """A numpy array or a JAX array (read through ``np.asarray``, which
    needs no JAX import here) -> a new tensor on ``device``, of ``dtype``
    (the array's own type if None).  Always a copy: a JAX array's host
    view is read-only."""
    return torch.tensor(np.asarray(x), device=device, dtype=dtype)
