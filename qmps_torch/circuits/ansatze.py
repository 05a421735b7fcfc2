"""State ansatz circuits (counterpart of ``qmps_tpu.circuits.ansatze``).

Ported: the 15-parameter exact SU(4) decomposition "full15"
(qmps/represent.py:382-404), the D = 2 state gate of the evolve path, as
its elementary-gate list and as its compiled unitary.  The rest of the zoo
waits (ROADMAP.md, item 9).
"""
from __future__ import annotations

import torch

from ..core import gates as g

#: rotation axis of each of the 15 parameters of shallow_full_state
_FULL15_AXES = "zxzzxzyyzzxzzxz"


def shallow_full_state_ops(params: torch.Tensor):
    """The 15-param SU(4) circuit as (gate, wires) ops on 2 qubits; params
    (..., 15) give batched gates."""
    p = params
    ops = [
        (g.rz(p[..., 0]), (0,)), (g.rx(p[..., 1]), (0,)), (g.rz(p[..., 2]), (0,)),
        (g.rz(p[..., 3]), (1,)), (g.rx(p[..., 4]), (1,)), (g.rz(p[..., 5]), (1,)),
        (g.CNOT, (0, 1)),
        (g.ry(p[..., 6]), (0,)),
        (g.CNOT, (1, 0)),
        (g.ry(p[..., 7]), (0,)), (g.rz(p[..., 8]), (1,)),
        (g.CNOT, (0, 1)),
        (g.rz(p[..., 9]), (0,)), (g.rx(p[..., 10]), (0,)), (g.rz(p[..., 11]), (0,)),
        (g.rz(p[..., 12]), (1,)), (g.rx(p[..., 13]), (1,)), (g.rz(p[..., 14]), (1,)),
    ]
    return ops, 2


def _kron2(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched kron of (..., 2, 2) with (..., 2, 2) -> (..., 4, 4)."""
    return torch.einsum("...ij,...kl->...ikjl", a, b).reshape(a.shape[:-2] + (4, 4))


def shallow_full_state(params: torch.Tensor) -> torch.Tensor:
    """(..., 15) params -> (..., 4, 4) unitary of ``shallow_full_state_ops``.

    Compiled as a product of seven 4x4 factors (four single-qubit layers
    as krons, three CNOTs) from all 15 rotations built in one batched op,
    instead of 18 gate applications: the evolve path calls this forward
    and backward on every inner step, where each PyTorch op costs host
    time."""
    R = g.rotations(params, _FULL15_AXES)  # (..., 15, 2, 2)
    # each qubit's rz rx rz block of the first and the last layer
    T = R[..., [2, 5, 11, 14], :, :] @ R[..., [1, 4, 10, 13], :, :] @ R[..., [0, 3, 9, 12], :, :]
    eye = torch.eye(2, dtype=R.dtype, device=R.device).expand_as(R[..., 6, :, :])
    left = torch.stack([T[..., 0, :, :], R[..., 6, :, :], R[..., 7, :, :], T[..., 2, :, :]], -3)
    right = torch.stack([T[..., 1, :, :], eye, R[..., 8, :, :], T[..., 3, :, :]], -3)
    K = _kron2(left, right)  # (..., 4, 4, 4): the four single-qubit layers
    cnot = g.CNOT.to(R.device, R.dtype)
    cnot10 = g.SWAP.to(R.device, R.dtype) @ cnot @ g.SWAP.to(R.device, R.dtype)
    return K[..., 3, :, :] @ cnot @ K[..., 2, :, :] @ cnot10 @ K[..., 1, :, :] @ cnot @ K[..., 0, :, :]
