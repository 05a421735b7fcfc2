"""Random circuit generators (op-list IR faces).

A copy of ``qmps_tpu.circuits.random``, which is host numpy (no JAX):
the port keeps its own copy so that it never imports the JAX package.
The op lists hold numpy gates; ``torch.from_numpy`` makes them the
port's.

The reference ships four cirq-based random-circuit factories used as data
by the bond-dimension experiments and its own tests
(qmps/tools.py:334-420): sparse random circuits (random SU(2)s + CNOTs,
PhysRevA.75.062314), dense layered random circuits, random QAOA circuits,
and "full-rank" ladder circuits whose layers are built so the induced MPS
matrices have full bond rank.  Here each factory returns a ``[(U, wires)]``
op list — the IR the whole stack consumes (circuit_state/circuit_unitary,
the noise/trajectory layers, and the OpenQASM exporter), generated host
-side with a seeded numpy Generator (these are data factories, not traced
compute).

The SU(2) sampling matches the reference's Haar parametrization:
psi, chi ~ U(0, 2 pi), phi = arcsin(sqrt(u)), gate = Rz(chi + psi)
Ry(2 phi) Rz(chi - psi).
"""
from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import numpy as np

Op = Tuple[np.ndarray, Sequence[int]]

_H = np.array([[1.0, 1.0], [1.0, -1.0]], dtype=complex) / math.sqrt(2.0)
_CX = np.array(
    [[1, 0, 0, 0], [0, 1, 0, 0], [0, 0, 0, 1], [0, 0, 1, 0]], dtype=complex
)
_CX_R = np.array(  # control on the SECOND wire
    [[1, 0, 0, 0], [0, 0, 0, 1], [0, 0, 1, 0], [0, 1, 0, 0]], dtype=complex
)
_SWAP = np.eye(4, dtype=complex)[[0, 2, 1, 3]]


def _rz(t):
    return np.diag([np.exp(-0.5j * t), np.exp(0.5j * t)])


def _ry(t):
    c, s = math.cos(t / 2.0), math.sin(t / 2.0)
    return np.array([[c, -s], [s, c]], dtype=complex)


def su2_from_angles(psi: float, chi: float, phi: float) -> np.ndarray:
    """Rz(chi+psi) Ry(2 phi) Rz(chi-psi) — Haar on SU(2) when psi, chi ~
    U(0, 2 pi) and phi = arcsin(sqrt(u))."""
    return _rz(chi + psi) @ _ry(2.0 * phi) @ _rz(chi - psi)


def _haar_su2(rng) -> np.ndarray:
    psi, chi = 2.0 * math.pi * rng.random(), 2.0 * math.pi * rng.random()
    phi = math.asin(math.sqrt(rng.random()))
    return su2_from_angles(psi, chi, phi)


def _rng(seed):
    return np.random.default_rng(seed)


def random_sparse_circuit(
    length: int, depth: int = 10, p: float = 0.5, seed=0
) -> List[Op]:
    """Sparse random circuit (qmps/tools.py:334-357): each of ``depth``
    steps is a Haar SU(2) on a random qubit with prob 1-p, else a CNOT on
    a random adjacent pair with random direction."""
    rng = _rng(seed)
    ops: List[Op] = []
    for _ in range(depth):
        if rng.random() > p:
            ops.append((_haar_su2(rng), (int(rng.integers(0, length)),)))
        else:
            i = int(rng.integers(0, length - 1))
            gate = _CX if rng.random() > 0.5 else _CX_R
            ops.append((gate, (i, i + 1)))
    return ops


def random_circuit(
    length: int,
    depth: int = 10,
    seed=0,
    angles: Optional[Sequence[Sequence[Tuple[float, float, float]]]] = None,
) -> List[Op]:
    """Dense layered random circuit (qmps/tools.py:359-381): per layer a
    (given or Haar) SU(2) on every qubit, then a CNOT ladder with random
    directions.  ``angles[j][i]`` optionally pins qubit i's (psi, chi,
    phi) in layer j — the reference's reproducibility hook."""
    rng = _rng(seed)
    ops: List[Op] = []
    for j in range(depth):
        for i in range(length):
            if angles is not None and angles[j][i][0] is not None:
                ops.append((su2_from_angles(*angles[j][i]), (i,)))
            else:
                ops.append((_haar_su2(rng), (i,)))
        for i in range(length - 1):
            ops.append((_CX if rng.random() > 0.5 else _CX_R, (i, i + 1)))
    return ops


def random_qaoa_circuit(
    length: int, depth: int = 1, seed=0, betas_gammas=None
) -> List[Op]:
    """Random QAOA layers (qmps/tools.py:383-392): X^beta on every qubit
    then ZZ^gamma on every adjacent pair, beta/gamma ~ N(0, 1)."""
    rng = _rng(seed)
    ops: List[Op] = []
    for j in range(depth):
        if betas_gammas is None:
            beta, gamma = rng.standard_normal(), rng.standard_normal()
        else:
            beta, gamma = betas_gammas[j]
        xb = _H @ np.diag([1.0, np.exp(1j * math.pi * beta)]) @ _H  # X^beta
        zzg = np.diag(
            [1.0, np.exp(1j * math.pi * gamma), np.exp(1j * math.pi * gamma), 1.0]
        )  # ZZ^gamma
        for i in range(length):
            ops.append((xb, (i,)))
        for i in range(length - 1):
            ops.append((zzg, (i, i + 1)))
    return ops


def random_full_rank_circuit(
    length: int, depth: int, seed=0, angles=None
) -> List[Op]:
    """Full-rank ladder circuit (qmps/tools.py:396-420) for the
    bond-dimension experiments: per layer, SU(2)s on qubits 1..L-1, a
    reversed CNOT ladder over them (an su(2^(L-1)) parametrization of the
    would-be MPS matrices), then H + CNOT entangling qubit 0 and a full
    SWAP cycle — depth-p ladder circuits whose induced D = 2^(L-1) MPS
    tensors are full bond rank (tested via middle-cut Schmidt rank)."""
    rng = _rng(seed)
    ops: List[Op] = []
    for j in range(depth):
        for i in range(1, length):
            if angles is not None and angles[j][i][0] is not None:
                ops.append((su2_from_angles(*angles[j][i]), (i,)))
            else:
                ops.append((_haar_su2(rng), (i,)))
        for i in reversed(range(1, length - 1)):
            ops.append((_CX, (i, i + 1)))
        ops.append((_H, (0,)))
        ops.append((_CX, (0, 1)))
        for i in range(length - 1):
            ops.append((_SWAP, (i, i + 1)))
        ops.append((_SWAP, (length - 1, 0)))
    return ops
