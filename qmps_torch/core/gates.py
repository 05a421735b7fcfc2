"""Dense gate set, cirq convention (counterpart of ``qmps_tpu.core.gates``).

Qubit 0 is the most significant bit; ``rx/ry/rz(t) = expm(-i t P / 2)``,
``pow_gate(P, t) = P_+ + e^{i pi t} P_-`` (cirq.XPowGate, ZZPowGate, ...)
and ``iswap_pow(t)`` a rotation by pi t / 2 in the {01, 10} block
(cirq.ISwapPowGate).  Angles are real tensors of any leading shape (a
Python number is taken as float64) and the gates come out as (..., 2, 2)
or (..., 4, 4) in the matching complex type (float64 -> complex128,
float32 -> complex64) on the angles' device.  The fixed gates are
complex128 CPU tensors, like the Pauli matrices.
"""
from __future__ import annotations

import math

import torch

from .paulis import PAULI, X, Y, Z

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


def _angle(t) -> torch.Tensor:
    """An angle as a tensor: a tensor as it is, anything else in float64."""
    return t if isinstance(t, torch.Tensor) else torch.as_tensor(t, dtype=torch.float64)


def rot(P: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """expm(-i t P / 2) = cos(t/2) I - i sin(t/2) P for an involutory P.

    ``P`` is one (2, 2) Pauli or a stack (n, 2, 2), one per last index of
    ``t``; then t (..., n) gives (..., n, 2, 2): all the rotations of a
    circuit in a few batched ops."""
    t = _angle(t)
    ct = complex_type(t)
    P = P.to(t.device, ct)
    eye = torch.eye(P.shape[-1], dtype=ct, device=t.device)
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


def pow_gate(P: torch.Tensor, t) -> torch.Tensor:
    """cirq PowGate of an involutory P: P_+ + e^{i pi t} P_- =
    e^{i pi t/2} (cos(pi t/2) I - i sin(pi t/2) P)."""
    t = _angle(t)
    return torch.exp(0.5j * math.pi * t)[..., None, None] * rot(P, math.pi * t)


def x_pow(t):
    return pow_gate(X, t)


def z_pow(t):
    """cirq.ZPowGate: diag(1, e^{i pi t})."""
    t = _angle(t)
    ph = torch.exp(1j * math.pi * t.to(complex_type(t)))
    return torch.diag_embed(torch.stack([torch.ones_like(ph), ph], -1))


def xx_pow(t):
    return pow_gate(torch.kron(X, X), t)


def yy_pow(t):
    return pow_gate(torch.kron(Y, Y), t)


def zz_pow(t):
    return pow_gate(torch.kron(Z, Z), t)


def _controlled(U: torch.Tensor) -> torch.Tensor:
    """|0><0| (x) I + |1><1| (x) U for (..., 2, 2) gates U, control on
    qubit 0."""
    out = torch.zeros(U.shape[:-2] + (4, 4), dtype=U.dtype, device=U.device)
    out[..., 0, 0] = out[..., 1, 1] = 1
    out[..., 2:, 2:] = U
    return out


def cnot_pow(t):
    """cirq.CNotPowGate: |0><0| (x) I + |1><1| (x) X^t."""
    return _controlled(x_pow(t))


def cry(t):
    """Controlled-Ry(t) (xmps.spin.CRy analogue)."""
    return _controlled(ry(t))


def iswap_pow(t):
    """cirq.ISwapPowGate(exponent=t): rotation in the {01, 10} block."""
    t = _angle(t)
    c = torch.cos(math.pi * t / 2).to(complex_type(t))
    s = 1j * torch.sin(math.pi * t / 2).to(complex_type(t))
    out = torch.zeros(t.shape + (4, 4), dtype=c.dtype, device=t.device)
    out[..., 0, 0] = out[..., 3, 3] = 1
    out[..., 1, 1] = out[..., 2, 2] = c
    out[..., 1, 2] = out[..., 2, 1] = s
    return out


SQRT_ISWAP = iswap_pow(0.5)
SQRT_ISWAP_INV = iswap_pow(-0.5)
