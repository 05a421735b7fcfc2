"""Numerics and device policy.

complex128/float64 is the correctness type (CPU tests, parity with the
JAX package); complex64/float32 is the speed type (the CUDA kernels are
float32).  Hot-path entry points take explicit ``device=``/``dtype=``.
"""
from __future__ import annotations

import torch

#: correctness types — tests and parity checks run in these.
CDTYPE = torch.complex128
RDTYPE = torch.float64

#: speed types — what the CUDA kernels take.
FAST_CDTYPE = torch.complex64
FAST_RDTYPE = torch.float32


def default_dtypes(device) -> tuple[torch.dtype, torch.dtype]:
    """(complex, real) working types for a device: 64-bit on the CPU,
    32-bit on CUDA (the kernels' type)."""
    if torch.device(device).type == "cuda":
        return FAST_CDTYPE, FAST_RDTYPE
    return CDTYPE, RDTYPE
