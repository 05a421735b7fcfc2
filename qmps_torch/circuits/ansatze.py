"""The ansatz zoo: parametrized state and environment circuits
(counterpart of ``qmps_tpu.circuits.ansatze``).

Each ansatz has two faces: ``<name>_ops(...) -> ([(gate, wires), ...], n)``,
the elementary-gate circuit on n qubits, and ``<name>(...)``, its compiled
unitary (``circuits.ir.circuit_unitary``).  Parameter layouts are the
reference cirq classes' (qmps/represent.py:268-442, qmps/ansatze.py,
scars.py:29-67).  Parameters (..., k) give batched gates and unitaries.

The D = 2 state gate of the evolve path, "full15" (qmps/represent.py:
382-404), is also compiled by hand (``shallow_full_state``) from its
15 rotations in one batched op.
"""
from __future__ import annotations

import math

import torch

from ..core import gates as g
from ..core import lie
from ..core.paulis import X
from .ir import circuit_unitary

#: rotation axis of each of the 15 parameters of shallow_full_state
_FULL15_AXES = "zxzzxzyyzzxzzxz"


def _n_qubits_state(D: int) -> int:
    return int(D).bit_length()  # log2(D) + 1


def _layers(params: torch.Tensor, k: int):
    """(..., L k) params -> the L layers' (..., k) parameter blocks."""
    params = g._angle(params)
    if params.shape[-1] % k:
        raise ValueError(f"need a multiple of {k} params, got {params.shape[-1]}")
    p = params.reshape(params.shape[:-1] + (-1, k))
    return [p[..., l, :] for l in range(p.shape[-2])]


def _cnot_ladder_reversed(n):
    """CNOTs n-2 -> n-1 down to 0 -> 1, the reference's reversed ladder."""
    return [(g.CNOT, (i, i + 1)) for i in reversed(range(n - 1))]


# -- state ansatze ------------------------------------------------------------


def shallow_qaoa_state_ops(D: int, params):
    """QAOA-style: an X^beta layer and a ZZ^gamma ladder per (beta, gamma)
    (qmps/represent.py:268-285)."""
    n = _n_qubits_state(D)
    ops = []
    for p in _layers(params, 2):
        ops += [(g.x_pow(p[..., 0]), (i,)) for i in range(n)]
        ops += [(g.zz_pow(p[..., 1]), (i, i + 1)) for i in range(n - 1)]
    return ops, n


def shallow_cnot_state_ops(D: int, params):
    """rz, rx, H and the reversed CNOT ladder per (beta, gamma)
    (qmps/represent.py:288-310), the production Loschmidt ansatz."""
    n = _n_qubits_state(D)
    ops = []
    for p in _layers(params, 2):
        ops += [(g.rz(p[..., 0]), (i,)) for i in range(n)]
        ops += [(g.rx(p[..., 1]), (i,)) for i in range(n)]
        ops += [(g.H, (0,))]
        ops += _cnot_ladder_reversed(n)
    return ops, n


def shallow_cnot_state_nonuniform_ops(D: int, params):
    """The per-qubit-parametrized variant (qmps/represent.py:312-332)."""
    n = _n_qubits_state(D)
    ops = []
    for p in _layers(params, 2 * n):
        ops += [(g.rz(p[..., i]), (i,)) for i in range(n)]
        ops += [(g.rx(p[..., i + n]), (i,)) for i in range(n)]
        ops += _cnot_ladder_reversed(n)
    return ops, n


def shallow_cnot_state3_ops(D: int, params):
    """The three-rotation variant (qmps/represent.py:334-354)."""
    n = _n_qubits_state(D)
    ops = []
    for p in _layers(params, 3):
        ops += [(g.rz(p[..., 0]), (i,)) for i in range(n)]
        ops += [(g.rx(p[..., 1]), (i,)) for i in range(n)]
        ops += [(g.rz(p[..., 2]), (i,)) for i in range(n)]
        ops += [(g.H, (0,))]
        ops += _cnot_ladder_reversed(n)
    return ops, n


def exact_after_4_ops(D: int, params):
    """6 params a layer, exact at depth 4 (qmps/represent.py:356-380)."""
    n = _n_qubits_state(D)
    ops = []
    for p in _layers(params, 6):
        ops += [(g.rz(p[..., 0]), (0,)), (g.rz(p[..., 3]), (1,))]
        ops += [(g.rx(p[..., 1]), (0,)), (g.rx(p[..., 4]), (1,))]
        ops += [(g.rz(p[..., 2]), (0,)), (g.rz(p[..., 5]), (1,))]
        ops += _cnot_ladder_reversed(n)
        ops += [(g.SWAP, (i, i + 1 if i != n - 1 else 0)) for i in range(n)]
    return ops, n


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


def state_gate_ops(params):
    """6-param XX/YY state gate (qmps/represent.py:406-423), the variational
    TDVP environment gate (new_time_evolve.py obj_state)."""
    p = g._angle(params)
    ops = [
        (g.rx(p[..., 0]), (0,)), (g.rx(p[..., 1]), (1,)),
        (g.rz(p[..., 2]), (0,)), (g.rz(p[..., 3]), (1,)),
        (g.xx_pow(p[..., 4]), (0, 1)), (g.yy_pow(p[..., 5]), (0, 1)),
    ]
    return ops, 2


def shallow_env_ops(D: int, params):
    """QAOA-style environment on 2 log2(D) qubits (qmps/represent.py:425-442)."""
    n = 2 * (int(D).bit_length() - 1)
    ops = []
    for p in _layers(params, 2):
        ops += [(g.x_pow(p[..., 0]), (i,)) for i in range(n)]
        ops += [(g.zz_pow(p[..., 1]), (i, i + 1)) for i in range(n - 1)]
    return ops, n


def env_vr_ops(params):
    """The reference's exact 6-param 2-qubit environment ansatz Vr
    (qmps/ansatze.py:9-25): (gamma, psi, phi, omega, delta, xi) ->
    YY^gamma, X^psi Z^phi on qubit 0, Z^-xi X^-omega Z^-delta on qubit 1."""
    p = g._angle(params)
    gamma, psi, phi, omega, delta, xi = (p[..., i] for i in range(6))
    ops = [
        (g.yy_pow(gamma), (0, 1)),
        (g.x_pow(psi), (0,)), (g.z_pow(phi), (0,)),
        (g.z_pow(-xi), (1,)), (g.x_pow(-omega), (1,)),
        (g.z_pow(-delta), (1,)),
    ]
    return ops, 2


def scars_ansatz_ops(params):
    """2-qubit PXP scars ansatz, params = [theta, phi] (scars.py:29-48)."""
    p = g._angle(params)
    th, ph = p[..., 0], p[..., 1]
    ops = [
        (g.z_pow(0.5 - ph / math.pi), (1,)),
        (X, (0,)),
        (g.CNOT, (0, 1)),
        (X, (0,)),
        (g.cnot_pow(2 * th / math.pi), (1, 0)),  # control on qubit 1, target 0
        (g.S, (0,)),
        (g.z_pow(-th / math.pi), (1,)),
    ]
    return ops, 2


def scar_gate_ops(params):
    """3-qubit 2-site scars gate, params = [th1, ph1, ph2, th2]
    (scars.py:50-67)."""
    p = g._angle(params)
    o2, _ = scars_ansatz_ops(torch.stack([p[..., 3], p[..., 2]], -1))
    o1, _ = scars_ansatz_ops(torch.stack([p[..., 0], p[..., 1]], -1))
    return [(U, tuple(w + 1 for w in wires)) for U, wires in o2] + o1, 3


def scars_tensor(th, ph) -> torch.Tensor:
    """Analytic MPS tensor A(theta, phi) of the scars ansatz (scars.py:69-72):
    (..., 2, 2, 2) for angles broadcast to (...)."""
    th, ph = torch.broadcast_tensors(g._angle(th), g._angle(ph))
    ct = g.complex_type(th)
    z = torch.zeros(th.shape, dtype=ct, device=th.device)
    row0 = torch.stack([torch.stack([z, 1j * torch.exp(-1j * ph.to(ct))], -1), torch.stack([z, z], -1)], -2)
    row1 = torch.stack([torch.stack([torch.cos(th).to(ct), z], -1), torch.stack([torch.sin(th).to(ct), z], -1)], -2)
    return torch.stack([row0, row1], -3)


def _compiled(ops_fn):
    def build(*args):
        ops, n = ops_fn(*args)
        return circuit_unitary(ops, n)

    build.__doc__ = f"The compiled unitary of ``{ops_fn.__name__}``."
    return build


shallow_qaoa_state = _compiled(shallow_qaoa_state_ops)
shallow_cnot_state = _compiled(shallow_cnot_state_ops)
shallow_cnot_state_nonuniform = _compiled(shallow_cnot_state_nonuniform_ops)
shallow_cnot_state3 = _compiled(shallow_cnot_state3_ops)
exact_after_4 = _compiled(exact_after_4_ops)
state_gate = _compiled(state_gate_ops)
shallow_env = _compiled(shallow_env_ops)
env_vr = _compiled(env_vr_ops)
scars_ansatz = _compiled(scars_ansatz_ops)
scar_gate = _compiled(scar_gate_ops)


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


def full_state_su4(params: torch.Tensor) -> torch.Tensor:
    """15-param dense SU(4) via the Lie exponential (xmps.spin.U4 path used
    by NonSparseFullEnergyOptimizer at D = 2)."""
    return lie.U4(params)


def full_state_suN(params: torch.Tensor, D: int) -> torch.Tensor:
    """(2D)^2 - 1 param dense SU(2D) state unitary for any D
    (qmps/ground_state.py:245-249)."""
    return lie.SU(params, 2 * D)


#: registry: name -> fn(D, params) -> the state unitary
STATE_ANSATZE = {
    "qaoa": shallow_qaoa_state,
    "cnot": shallow_cnot_state,
    "cnot_nonuniform": shallow_cnot_state_nonuniform,
    "cnot3": shallow_cnot_state3,
    "exact_after_4": exact_after_4,
    "full15": lambda D, p: shallow_full_state(p),
    "su4": lambda D, p: full_state_su4(p),
    "suN": lambda D, p: full_state_suN(p, D),
}

#: ops-level registry: name -> fn(D, params) -> (ops, n)
STATE_ANSATZE_OPS = {
    "qaoa": shallow_qaoa_state_ops,
    "cnot": shallow_cnot_state_ops,
    "cnot_nonuniform": shallow_cnot_state_nonuniform_ops,
    "cnot3": shallow_cnot_state3_ops,
    "exact_after_4": exact_after_4_ops,
    "full15": lambda D, p: shallow_full_state_ops(p),
}
