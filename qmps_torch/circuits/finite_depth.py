"""Finite-depth brick-wall (staircase/lightcone) states (counterpart of
``qmps_tpu.circuits.finite_depth``; scripts/finite_depth/finite_depth.py).

Pyramid-shaped brick-wall circuits of a given depth approximating the
infinite state on a finite window, their growth under a Trotter layer,
and central-window expectation values: the machinery behind the
reference's local-against-global overlap comparisons.  The ansatz
unitaries come out in the complex type of their parameters (a Python
list in complex128); the states in their bricks' type and on their
device.
"""
from __future__ import annotations

import math

import torch

from ..core import gates as g
from ..core.paulis import I2, kron_all
from .ir import apply_unitary, circuit_unitary


def _padded(p, multiple: int) -> torch.Tensor:
    p = g._angle(p)
    return torch.cat([p, p.new_zeros((-p.shape[0]) % multiple)])


def ladder_ansatz(p) -> torch.Tensor:
    """Rx (x) Rx, Rz (x) Rz + CNOT per 4 params, the pure-numpy CNOT-ladder
    ansatz of scripts/ground_state_finding.py:83-92."""
    p = _padded(p, 4)
    ct = g.complex_type(p)
    U = torch.eye(4, dtype=ct, device=p.device)
    cnot = g.CNOT.to(p.device, ct)
    for w, x, u, v in p.reshape(-1, 4):
        U = cnot @ torch.kron(g.rz(u), g.rz(v)) @ torch.kron(g.rx(w), g.rx(x)) @ U
    return U


def real_ansatz(p) -> torch.Tensor:
    """Ry (x) Ry + CZ per 2 params: a real-valued 2-qubit family
    (scripts/ground_state_finding.py:94-102, finite_depth.py)."""
    p = _padded(p, 2)
    ct = g.complex_type(p)
    U = torch.eye(4, dtype=ct, device=p.device)
    cz = g.CZ.to(p.device, ct)
    for w, x in p.reshape(-1, 2):
        U = cz @ torch.kron(g.ry(w), g.ry(x)) @ U
    return U


def real_hermitian_ansatz(p) -> torch.Tensor:
    """Real hermitian 2-qubit family via controlled-Ry conjugations
    (scripts/ground_state_finding.py:104-110)."""
    p = g._angle(p)
    ct = g.complex_type(p)
    U = torch.eye(4, dtype=ct, device=p.device)
    swap, eye = g.SWAP.to(p.device, ct), I2.to(p.device, ct)
    for w in p:
        ent = swap @ g.cry(math.pi - w) @ swap @ g.cry(-w)
        U = ent @ torch.kron(g.ry(w), eye) @ U
    return U


def _zero_state(n: int, U: torch.Tensor) -> torch.Tensor:
    psi = torch.zeros(2**n, dtype=U.dtype, device=U.device)
    psi[0] = 1.0
    return psi


def staircase_state(U: torch.Tensor, depth: int = 2, support: int = 2) -> torch.Tensor:
    """Pyramid brick-wall state: ``depth`` staggered layers of the 2-qubit
    brick U over a window wide enough that the central ``support`` qubits
    see the full lightcone (brick_wall_state, finite_depth.py:66-81).

    Layer k applies U on pairs offset by k qubits from each edge, the
    widest layer first, narrowing toward the central support (the
    lightcone pyramid of finite_depth.py:76-81).  Qubit count
    2 (depth - 1) + 2 ceil(support / 2)."""
    n = 2 * (depth - 1) + 2 * ((support + 1) // 2)
    psi = _zero_state(n, U)
    for off in range(depth):  # offset from each edge, widest layer first
        for q in range(off, n - off - 1, 2):
            psi = apply_unitary(psi, U, (q, q + 1), n)
    return psi


def grow_staircase(U: torch.Tensor, W: torch.Tensor, depth: int = 2, support: int = 2) -> torch.Tensor:
    """State of depth+2 whose two innermost (last-applied, narrowest)
    layers are the Trotter brick W instead of U (brick_wall_state.grow,
    finite_depth.py:84-106): finite-depth evolution of the staircase."""
    total = depth + 2
    n = 2 * (total - 1) + 2 * ((support + 1) // 2)
    psi = _zero_state(n, U)
    W = W.to(U.device, U.dtype)
    for off in range(total):  # widest first; the last two layers are W
        brick = U if off < depth else W
        for q in range(off, n - off - 1, 2):
            psi = apply_unitary(psi, brick, (q, q + 1), n)
    return psi


def central_expectation(psi: torch.Tensor, H: torch.Tensor) -> torch.Tensor:
    """<H> on the central 2 qubits (brick_wall_state.ev, finite_depth.py:108-113)."""
    n = int(psi.shape[0]).bit_length() - 1
    if H.shape[0] == 2:
        H = torch.kron(H, I2.to(H.device, H.dtype))
    pad = (n - 2) // 2
    eye = I2.to(psi.device, psi.dtype)
    Hfull = kron_all([eye] * pad + [H.to(psi.device, psi.dtype)] + [eye] * (n - 2 - pad))
    return (psi.conj() @ (Hfull @ psi)).real


def brick_wall_unitary(U: torch.Tensor, depth: int = 2) -> torch.Tensor:
    """The (depth+1)-qubit staircase unitary whose first column block embeds
    the finite-depth MPS isometry (brick_wall_unitary, finite_depth.py:122-130)."""
    n = depth + 1
    ops = [(U, (n - 2 - i, n - 1 - i)) for i in range(depth)]
    return circuit_unitary(ops, n)


def local_global_overlap(U1: torch.Tensor, U2: torch.Tensor, depth: int, support: int = 2):
    """(local, global) overlaps of two staircase states: the central-window
    fidelity of the reduced density matrices (Uhlmann) and the full-window
    fidelity."""
    from ..env.variational import reduced_density_matrix

    psi1 = staircase_state(U1, depth, support)
    psi2 = staircase_state(U2, depth, support)
    n = int(psi1.shape[0]).bit_length() - 1
    glob = torch.vdot(psi1, psi2).abs() ** 2
    mid = [(n - 2) // 2, (n - 2) // 2 + 1]
    r1 = reduced_density_matrix(psi1, mid, n)
    r2 = reduced_density_matrix(psi2, mid, n)
    s1 = _sqrtm_psd(r1)
    loc = _sqrtm_psd(s1 @ r2 @ s1).diagonal().sum().real ** 2
    return loc, glob


def _sqrtm_psd(M: torch.Tensor) -> torch.Tensor:
    w, V = torch.linalg.eigh((M + M.mH) / 2)
    return (V * w.clamp(min=0.0).sqrt()[None, :].to(V.dtype)) @ V.mH
