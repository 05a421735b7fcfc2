"""Dense gate set, cirq convention (counterpart of ``qmps_tpu.core.gates``).

Qubit 0 is the most significant bit; ``rx/ry/rz(t) = expm(-i t P / 2)``.
Angles are real tensors of any leading shape and the gates come out as
(..., 2, 2) in the matching complex type (float64 -> complex128, float32
-> complex64) on the angles' device.  The fixed gates are complex128 CPU
tensors, like the Pauli matrices.
"""
from __future__ import annotations

import math

import torch

from .paulis import I2, PAULI, X, Y, Z

H = torch.tensor([[1, 1], [1, -1]], dtype=torch.complex128) / math.sqrt(2.0)
S = torch.tensor([[1, 0], [0, 1j]], dtype=torch.complex128)
S_DAG = S.conj().resolve_conj()
T = torch.tensor([[1, 0], [0, complex(math.cos(math.pi / 4), math.sin(math.pi / 4))]],
                 dtype=torch.complex128)
CNOT = torch.tensor(
    [[1, 0, 0, 0], [0, 1, 0, 0], [0, 0, 0, 1], [0, 0, 1, 0]], dtype=torch.complex128
)
CZ = torch.diag(torch.tensor([1, 1, 1, -1], dtype=torch.complex128))
SWAP = torch.tensor(
    [[1, 0, 0, 0], [0, 0, 1, 0], [0, 1, 0, 0], [0, 0, 0, 1]], dtype=torch.complex128
)


def complex_type(t: torch.Tensor) -> torch.dtype:
    """The complex type that goes with a real (or complex) tensor's type."""
    return torch.promote_types(t.dtype, torch.complex64)


def rot(P: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """expm(-i t P / 2) = cos(t/2) I - i sin(t/2) P for an involutory P.

    ``P`` is one (2, 2) Pauli or a stack (n, 2, 2), one per last index of
    ``t``; then t (..., n) gives (..., n, 2, 2): all the rotations of a
    circuit in a few batched ops."""
    t = torch.as_tensor(t)
    ct = complex_type(t)
    P = P.to(t.device, ct)
    eye = I2.to(t.device, ct)
    c = torch.cos(t / 2)[..., None, None]
    s = torch.sin(t / 2)[..., None, None]
    return c * eye - 1j * s * P


def rotations(t: torch.Tensor, axes: str) -> torch.Tensor:
    """t (..., n) angles and ``axes`` a string of n of 'x', 'y', 'z' ->
    (..., n, 2, 2): the k-th rotation about axes[k] by t[..., k]."""
    return rot(torch.stack([PAULI[a.upper()] for a in axes]), t)


def rx(t):
    return rot(X, t)


def ry(t):
    return rot(Y, t)


def rz(t):
    return rot(Z, t)
