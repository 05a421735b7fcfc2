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


def kron_all(ops: Sequence[torch.Tensor]) -> torch.Tensor:
    """Tensor product of a list of matrices (qubit 0 first)."""
    return reduce(torch.kron, ops)
