"""Pauli matrices (full sigma convention, as ``qmps_tpu.core.paulis``),
as complex128 CPU tensors; callers move them where they need them."""
from __future__ import annotations

import torch

I2 = torch.eye(2, dtype=torch.complex128)
X = torch.tensor([[0, 1], [1, 0]], dtype=torch.complex128)
Z = torch.tensor([[1, 0], [0, -1]], dtype=torch.complex128)
