"""Deep brick-wall uMPS ansatz (counterpart of
``qmps_tpu.circuits.brickwork_deep``): bond dimension D = 2^(n-1) from a
depth-d wall of parameterized SU(4) KAK bricks on n qubits.

Layer k applies bricks on the wire pairs (i, i+1), i = k % 2, k % 2 + 2,
..., so the parameter count grows like depth * n * 19 instead of (2D)^2.
All the bricks of a wall are built in one batched ``core.lie.U4_kak``
call and compiled to the dense unitary by ``circuits.ir.circuit_unitary``;
parameters (..., n_params) give (..., 2^n, 2^n) unitaries, one per row.
"""
from __future__ import annotations

from typing import List, Tuple

import torch

from ..core.lie import U4_kak
from .ir import circuit_unitary

BRICK_PARAMS = 19  # per-brick KAK parameter count (core/lie.U4_kak)


def brick_layout(n_qubits: int, depth: int) -> List[Tuple[int, int]]:
    """Wire pairs of the depth-layer brick wall: layer k applies bricks on
    (i, i+1) for i = k%2, k%2+2, ... (the gen-2 cell is n=2, depth=2)."""
    pairs: List[Tuple[int, int]] = []
    for k in range(depth):
        pairs += [(i, i + 1) for i in range(k % 2, n_qubits - 1, 2)]
    return pairs


def n_brick_params(n_qubits: int, depth: int) -> int:
    return BRICK_PARAMS * len(brick_layout(n_qubits, depth))


def brick_wall_ops(params, n_qubits: int, depth: int):
    """``[(U, wires)]`` op list of the wall, each U (..., 4, 4): the IR
    face, consumable by ``circuit_unitary`` and ``circuit_state``."""
    layout = brick_layout(n_qubits, depth)
    p = torch.as_tensor(params)
    bricks = U4_kak(p.reshape(p.shape[:-1] + (len(layout), BRICK_PARAMS)))
    return [(bricks[..., b, :, :], layout[b]) for b in range(len(layout))]


def brick_wall_unitary(params, n_qubits: int, depth: int) -> torch.Tensor:
    """Dense (..., 2^n, 2^n) unitary of the wall."""
    return circuit_unitary(brick_wall_ops(params, n_qubits, depth), n_qubits)


def brick_wall_tensor(params, D: int, depth: int) -> torch.Tensor:
    """(..., 2, D, D) left-canonical uMPS tensor of the depth-d wall at
    bond dimension D = 2^(n-1) (D must be a power of two)."""
    from ..embed.unitaries import unitary_to_tensor

    return unitary_to_tensor(brick_wall_unitary(params, _n_qubits(D), depth))


def _n_qubits(D: int) -> int:
    n = int(D).bit_length()  # 2D = 2^n  ->  n = log2(D) + 1
    if 2 ** (n - 1) != D:
        raise ValueError(f"deep brickwork needs a power-of-two D, got {D}")
    return n
