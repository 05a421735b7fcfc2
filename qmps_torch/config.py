"""Numerics and device policy.

complex128/float64 is the correctness type (CPU tests, parity with the
JAX package); complex64/float32 is the speed type (the CUDA kernels are
float32).

Device rule, for every entry point (:func:`resolve_device`): an explicit
``device=`` wins; else a function that was given tensors runs where they
are; else (floats, lists, numpy arrays or a seed) it runs on the CUDA
card, and raises where there is none.  No entry point falls back to the
CPU on its own: the CPU is asked for with ``device="cpu"``.

Precision (:func:`default_dtypes`): 64-bit on the CPU, 32-bit on CUDA;
``find_ground_state`` and the brickwork entry points given their start,
state or Hamiltonian as a tensor take its precision instead (so the
card's float32 numerics can also run on the CPU).
"""
from __future__ import annotations

import numpy as np
import torch

#: correctness types — tests and parity checks run in these.
CDTYPE = torch.complex128
RDTYPE = torch.float64

#: their numpy twins, for host constants
NP_CDTYPE = np.complex128
NP_RDTYPE = np.float64

#: speed types — what the CUDA kernels take.
FAST_CDTYPE = torch.complex64
FAST_RDTYPE = torch.float32


def resolve_device(device=None, *like) -> torch.device:
    """The device an entry point runs on: ``device`` if given, else the
    device of the first tensor among ``like``, else CUDA.  Raises if that
    is CUDA and the machine has no card."""
    if device is None:
        device = next((t.device for t in like if isinstance(t, torch.Tensor)), "cuda")
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: qmps_torch entry points run on the card unless they are "
            "given CPU tensors or device='cpu'"
        )
    return device


def default_dtypes(device, like=None) -> tuple[torch.dtype, torch.dtype]:
    """(complex, real) working types: 32-bit if ``like`` is a float32 or
    complex64 tensor, 64-bit if it is another tensor; else by device,
    64-bit on the CPU and 32-bit on CUDA (the kernels' type)."""
    if isinstance(like, torch.Tensor):
        fast = like.dtype in (FAST_CDTYPE, FAST_RDTYPE)
    else:
        fast = torch.device(device).type == "cuda"
    return (FAST_CDTYPE, FAST_RDTYPE) if fast else (CDTYPE, RDTYPE)
