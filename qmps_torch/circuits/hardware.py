"""Hardware-native (sqrt-iSWAP) gate compilations for Google-style devices
(counterpart of ``qmps_tpu.circuits.hardware``; experiments/Jamie.py:
13-168).

Each gate is a dense unitary composed through the circuit compiler, so the
native-gate calibration stack is differentiable in its angles.  Angles are
real tensors or Python numbers (float64); a gate comes out in the complex
type of its angles and on their device.
"""
from __future__ import annotations

import functools
import math

import torch

from ..core import gates as g
from ..core.paulis import X, Y
from .ir import circuit_unitary


def _unitary(ops, *angles) -> torch.Tensor:
    """The 2-qubit unitary of ``ops`` in the complex type of ``angles``."""
    ts = [g._angle(a) for a in angles]
    ct = functools.reduce(torch.promote_types, [g.complex_type(t) for t in ts])
    return circuit_unitary(ops, 2, dtype=ct, device=ts[0].device)


def K_gate(theta) -> torch.Tensor:
    """K(theta): number-conserving 2-qubit rotation from two sqrt-iSWAPs
    (experiments/Jamie.py:38-55); equals exp(-i theta (XX+YY)/2) up to frame."""
    ops = [
        (g.rz(-math.pi / 4), (0,)),
        (g.rz(math.pi / 4), (1,)),
        (g.SQRT_ISWAP, (0, 1)),
        (g.rz(theta), (0,)),
        (g.rz(-g._angle(theta)), (1,)),
        (g.SQRT_ISWAP_INV, (0, 1)),
        (g.rz(math.pi / 4), (0,)),
        (g.rz(-math.pi / 4), (1,)),
    ]
    return _unitary(ops, theta)


def expYY_gate(gamma) -> torch.Tensor:
    """exp(i gamma YY) from K gates (experiments/Jamie.py:57-70)."""
    ops = [
        (K_gate(gamma), (0, 1)),
        (X, (1,)),
        (K_gate(-g._angle(gamma)), (0, 1)),
        (X, (1,)),
    ]
    return _unitary(ops, gamma)


def V_env_gate(params) -> torch.Tensor:
    """3-param hardware-native environment ansatz (experiments/Jamie.py:72-86)."""
    params = g._angle(params)
    gamma, psi, phi = params[0], params[1], params[2]
    ops = [
        (expYY_gate(gamma), (0, 1)),
        (g.rx(psi), (1,)),
        (g.rz(phi), (1,)),
    ]
    return _unitary(ops, params)


def CPHASE_gate(phi, alpha, xi1, xi2) -> torch.Tensor:
    """CPHASE from two sqrt-iSWAPs (experiments/Jamie.py:88-109)."""
    phi, alpha, xi1, xi2 = (g._angle(a) for a in (phi, alpha, xi1, xi2))
    ops = [
        (g.rz(-phi / 2), (0,)),
        (g.rz(-phi / 2), (1,)),
        (g.rx(xi1), (0,)),
        (g.rx(xi2), (1,)),
        (g.SQRT_ISWAP_INV, (0, 1)),
        (g.rx(-2 * alpha), (0,)),
        (g.SQRT_ISWAP_INV, (0, 1)),
        (g.rx(xi1), (0,)),
        (g.rx(-xi2), (1,)),
    ]
    return _unitary(ops, phi, alpha, xi1, xi2)


def TFIM_trotter_gate(J, gval, xi1, xi2, alpha) -> torch.Tensor:
    """One TFIM Trotter step in the native gate set
    (experiments/Jamie.py:121-146)."""
    ops = [
        (Y, (0,)),
        (Y, (1,)),
        (K_gate(J), (0, 1)),
        (X, (1,)),
        (K_gate(J), (0, 1)),
        (X, (0,)),
        (CPHASE_gate(gval, alpha, xi1, xi2), (0, 1)),
        (X, (0,)),
        (X, (1,)),
        (CPHASE_gate(gval, alpha, xi1, xi2), (0, 1)),
        (Y, (0,)),
        (Y, (1,)),
    ]
    return _unitary(ops, J, gval, xi1, xi2, alpha)


def right_environment_gate(params) -> torch.Tensor:
    """3-param right-environment ansatz (experiments/Jamie.py:148-167)."""
    params = g._angle(params)
    th, psi, phi = params[0], params[1], params[2]
    ops = [
        (g.rz(psi), (1,)),
        (g.rx(phi), (1,)),
        (g.rx(th), (0,)),
        (g.SWAP @ g.CNOT @ g.SWAP, (0, 1)),  # CNOT controlled on qubit 1
        (g.rx(th), (0,)),
        (g.rx(-phi), (1,)),
        (g.rz(-psi), (1,)),
    ]
    return _unitary(ops, params)


def ry_sqrtiswap_layer_gate(depth: int, params) -> torch.Tensor:
    """Repeated [ry, ry, sqrt-iSWAP] layers (experiments/Jamie.py:13-35)."""
    params = g._angle(params).reshape(depth, 2)
    ops = []
    for i in range(depth):
        ops += [
            (g.ry(params[i, 0]), (0,)),
            (g.ry(params[i, 1]), (1,)),
            (g.SQRT_ISWAP, (0, 1)),
        ]
    return _unitary(ops, params)
