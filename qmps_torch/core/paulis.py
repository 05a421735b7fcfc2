"""Pauli matrices (full sigma convention, as ``qmps_tpu.core.paulis``),
as complex128 CPU tensors; callers move them where they need them."""
from __future__ import annotations

from functools import reduce
from typing import Sequence

import torch

I2 = torch.eye(2, dtype=torch.complex128)
X = torch.tensor([[0, 1], [1, 0]], dtype=torch.complex128)
Y = torch.tensor([[0, -1j], [1j, 0]], dtype=torch.complex128)
Z = torch.tensor([[1, 0], [0, -1]], dtype=torch.complex128)

#: single-qubit Pauli dict used by the Hamiltonian string builder
PAULI = {"I": I2, "X": X, "Y": Y, "Z": Z}


def paulis():
    """(X, Y, Z): the trio the reference unpacks everywhere."""
    return X, Y, Z


def kron_all(ops: Sequence[torch.Tensor]) -> torch.Tensor:
    """Tensor product of a list of matrices (qubit 0 first)."""
    return reduce(torch.kron, ops)


def pauli_string(s: str) -> torch.Tensor:
    """'ZZ' -> Z (x) Z, etc."""
    return kron_all([PAULI[c] for c in s])


def embed(op: torch.Tensor, loc: int, n_qubits: int) -> torch.Tensor:
    """I^loc (x) op (x) I^rest on n_qubits qubits (op may span several)."""
    k = int(op.shape[0]).bit_length() - 1
    return kron_all([I2] * loc + [op] + [I2] * (n_qubits - loc - k))
