"""Executable-circuit export: op-list IR -> OpenQASM 2.0 text.

A copy of ``qmps_tpu.circuits.export``, which is host numpy (no JAX):
the port keeps its own copy so that it never imports the JAX package.
An op list of torch gates exports as it is (``np.asarray`` of a CPU
tensor); ``parse_openqasm``'s numpy gates compile with the port's
``circuits.ir.circuit_unitary`` once made tensors.

Gen-1 of the reference emits cirq Gate objects that plug into a real
device pipeline (qmps/represent.py:188-265; the sqrt-iSWAP natives in
experiments/Jamie.py:38-146 exist to run on Google hardware).  The
rebuild compiles circuits to dense tensors for simulation —
this module closes the loop outward: any ``[(U, wires)]`` op list whose
gates act on <= 2 qubits serializes to OpenQASM 2.0 (u3/cx only), so the
ansatz zoo, the TDVP/Loschmidt circuits, and hardware-native sequences
can be handed to an external stack (qiskit, cirq via qasm import, real
backends).

This is a HOST-SIDE tool (numpy complex128, not jitted): export runs
once per circuit, not in an optimization loop.

Decomposition: 1q gates by ZYZ Euler angles -> u3; 2q gates by the magic
-basis KAK factorization U = (g3 (x) g4) exp(i(a XX + b YY + c ZZ))
(g1 (x) g2), with each commuting interaction term compiled exactly as a
basis change around exp(i t ZZ) = cx . (I (x) rz(-2t)) . cx.  Six CNOTs
per generic 2q gate — correct and numerically robust everywhere (the
3-CNOT minimal circuit trades conditioning for depth; export targets
parity, not gate-count optimality).  Global phase is returned separately
(OpenQASM 2.0 cannot express it); ``parse_openqasm`` + circuit_unitary
round-trips every exported circuit to 1e-10 up to that phase (tested).
"""
from __future__ import annotations

import math
from typing import Iterable, List, Sequence, Tuple

import numpy as np

Op = Tuple[np.ndarray, Sequence[int]]

_I = np.eye(2)
_X = np.array([[0.0, 1.0], [1.0, 0.0]])
_Y = np.array([[0.0, -1.0j], [1.0j, 0.0]])
_Z = np.array([[1.0, 0.0], [0.0, -1.0]])
_H = np.array([[1.0, 1.0], [1.0, -1.0]]) / math.sqrt(2.0)
_CX = np.array(
    [[1, 0, 0, 0], [0, 1, 0, 0], [0, 0, 0, 1], [0, 0, 1, 0]], dtype=float
)
# magic basis: B maps the Bell basis to the computational basis; conjugating
# SO(4) by B gives SU(2) x SU(2)
_B = np.array(
    [[1, 0, 0, 1j], [0, 1j, 1, 0], [0, 1j, -1, 0], [1, 0, 0, -1j]],
    dtype=complex,
) / math.sqrt(2.0)


def _u3(theta, phi, lam):
    """OpenQASM u3 gate convention (qiskit): Rz(phi) Ry(theta) Rz(lam)
    with u3(t,p,l) = [[cos(t/2), -e^{il} sin(t/2)],
                      [e^{ip} sin(t/2), e^{i(p+l)} cos(t/2)]]."""
    c, s = math.cos(theta / 2.0), math.sin(theta / 2.0)
    return np.array(
        [
            [c, -np.exp(1j * lam) * s],
            [np.exp(1j * phi) * s, np.exp(1j * (phi + lam)) * c],
        ]
    )


def zyz_angles(U: np.ndarray) -> Tuple[float, float, float, float]:
    """(theta, phi, lam, global_phase) with U = e^{i gp} u3(theta, phi, lam).

    Valid for any 2x2 unitary; branch cuts handled so u3 reconstruction is
    exact to machine precision (tested over random U(2))."""
    U = np.asarray(U, dtype=complex)
    det = np.linalg.det(U)
    gp = 0.5 * np.angle(det)
    V = U * np.exp(-1j * gp)  # SU(2)
    # V = [[a, -conj(b)], [b, conj(a)]]
    a, b = V[0, 0], V[1, 0]
    theta = 2.0 * math.atan2(abs(b), abs(a))
    if abs(b) < 1e-12:
        # diagonal: only phi + lam matters; put it all in phi
        phi = float(np.angle(V[1, 1]) - np.angle(V[0, 0]))
        lam = 0.0
        rec = _u3(theta, phi, lam)
        gp = np.angle(U[0, 0] / rec[0, 0])
    elif abs(a) < 1e-12:
        phi = float(np.angle(V[1, 0]))
        lam = float(np.angle(-V[0, 1]))
        rec = _u3(theta, phi, lam)
        gp = np.angle(U[1, 0] / rec[1, 0])
    else:
        phi = float(np.angle(V[1, 0] / a * abs(a) / abs(b)))
        lam = float(np.angle(-V[0, 1] / a * abs(a) / abs(b)))
        rec = _u3(theta, phi, lam)
        gp = np.angle(U[0, 0] / rec[0, 0])
    return float(theta), float(phi), float(lam), float(gp)


def _kron(a, b):
    return np.kron(a, b)


def _closest_so4_factor(M: np.ndarray):
    """Eigendecompose the symmetric unitary M = Q Lam Q^T with Q real
    orthogonal.  Re(M) and Im(M) are commuting real symmetrics; a joint
    eigenbasis is found from a generic linear combination (retry over
    fixed irrational mixes for degenerate spectra)."""
    A, C = M.real, M.imag
    for t in (0.37840124, 0.77253418, 1.23371142, 0.11111317):
        w, Q = np.linalg.eigh(A + t * C)
        D = Q.T @ M @ Q
        if np.max(np.abs(D - np.diag(np.diagonal(D)))) < 1e-10:
            return Q, np.diagonal(D).copy()
    raise np.linalg.LinAlgError("joint diagonalization failed")


def kak_decompose(U: np.ndarray):
    """U (4x4 unitary) = e^{i gp} (g2 (x) g3) exp(i(a XX + b YY + c ZZ))
    (g0 (x) g1).

    Returns (gp, (g0, g1), (a, b, c), (g2, g3)).  Magic-basis algorithm:
    V = B^dag U B; M = V^T V = Q Lam Q^T (Q in SO(4)); S = Lam^{1/2};
    W = V Q S^{-1} Q^T ... assembled so the outer factors map back to
    local SU(2) pairs.  Verified by reconstruction to 1e-12 over random
    U(4) (see tests/test_export.py)."""
    U = np.asarray(U, dtype=complex)
    det = np.linalg.det(U)
    gp0 = np.angle(det) / 4.0
    Us = U * np.exp(-1j * gp0)  # det 1

    V = _B.conj().T @ Us @ _B
    M = V.T @ V
    Q, lam = _closest_so4_factor(M)
    if np.linalg.det(Q) < 0:
        Q[:, 0] = -Q[:, 0]
    # S = sqrt of the eigenvalues; det V = 1 => prod lam = 1 => sum of the
    # raw half-angles is a multiple of pi — shift one branch so it is 0,
    # which makes det S = 1 and hence W1 in SO(4) (real by W1^T W1 = I =
    # W1^dag W1, det +1 by det V = det W1 det S det Q).
    phis = np.angle(lam) / 2.0
    k = round(float(np.sum(phis)) / math.pi)
    if k != 0:
        phis[0] -= k * math.pi
    S = np.exp(1j * phis)
    W1 = V @ Q @ np.diag(1.0 / S)  # V = W1 diag(S) Q^T
    if np.max(np.abs(W1.imag)) > 1e-8 or np.linalg.det(W1).real < 0:
        raise np.linalg.LinAlgError("KAK: left factor not in SO(4)")
    # back to the computational basis: both real-orthogonal factors map to
    # local SU(2) pairs, the middle diagonal to the canonical interaction
    L = _B @ W1.real @ _B.conj().T  # = g2 (x) g3 (up to phase)
    R = _B @ Q.T @ _B.conj().T  # = g0 (x) g1
    # B diag(e^{i phi}) B^dag = exp(i(a XX + b YY + c ZZ)) with
    # phi = (a-b+c, a+b-c, -a-b-c, -a+b+c)  (verified numerically):
    p0, p1, p2, _ = phis
    a = (p0 + p1) / 2.0
    b = -(p0 + p2) / 2.0
    c = -(p1 + p2) / 2.0
    g0, g1, gpR = _split_local(R)
    g2, g3, gpL = _split_local(L)
    gp = gp0 + gpR + gpL
    return gp, (g0, g1), (float(a), float(b), float(c)), (g2, g3)


def _split_local(G: np.ndarray):
    """Split G = e^{i gp} (g_hi (x) g_lo) into 2x2 unitaries (G is a
    Kronecker product up to phase by construction)."""
    G = np.asarray(G, dtype=complex)
    # partial trace trick: G reshaped (2, 2, 2, 2) as G[i,j,k,l] =
    # hi[i,k] lo[j,l] * e^{i gp}
    Gr = G.reshape(2, 2, 2, 2).transpose(0, 2, 1, 3).reshape(4, 4)
    # Gr = vec-outer: Gr[(i k), (j l)] = hi[i,k] lo[j,l]; rank 1
    u, s, vh = np.linalg.svd(Gr)
    if s[1] > 1e-9:
        raise np.linalg.LinAlgError("not a local (kron) gate")
    # Gr = s0 * outer(u0, vh0): vec(hi) prop u0, vec(lo) prop vh0
    hi = u[:, 0].reshape(2, 2) * math.sqrt(s[0])
    lo = vh[0, :].reshape(2, 2) * math.sqrt(s[0])
    # push the arbitrary scalar phase of the split into gp (rotate each
    # factor toward unit determinant for well-conditioned zyz export)
    hi = hi * np.exp(-0.5j * np.angle(np.linalg.det(hi)))
    lo = lo * np.exp(-0.5j * np.angle(np.linalg.det(lo)))
    rec = np.kron(hi, lo)
    nz = np.unravel_index(np.argmax(np.abs(rec)), rec.shape)
    gp = float(np.angle(G[nz] / rec[nz]))
    return hi, lo, gp


# ---------------------------------------------------------------------------
# emission
# ---------------------------------------------------------------------------


def _emit_1q(lines: List[str], U, q: int) -> float:
    theta, phi, lam, gp = zyz_angles(U)
    lines.append(f"u3({theta:.17g},{phi:.17g},{lam:.17g}) q[{q}];")
    return gp


def _emit_zz(lines: List[str], t: float, q0: int, q1: int):
    """exp(i t ZZ) = cx; rz(-2t) on target; cx  (up to global phase e^{it}
    ... exactly: cx (I (x) Rz(-2t)) cx = diag(e^{-it}, e^{it}, e^{it},
    e^{-it}) * e^{i t}?  Rz(th) = diag(e^{-i th/2}, e^{i th/2});
    cx (I (x) Rz(-2t)) cx = diag(e^{it}, e^{-it}, e^{-it}, e^{it}) =
    exp(i t ZZ).  Phase-exact."""
    lines.append(f"cx q[{q0}],q[{q1}];")
    lines.append(f"u3(0,{-2.0 * t:.17g},0) q[{q1}];")  # u3(0,phi,0)=diag(1, e^{i phi})
    lines.append(f"cx q[{q0}],q[{q1}];")
    # emitted = diag(1, e^{-2it}, e^{-2it}, 1) = e^{-it} exp(i t ZZ)
    return t


def _emit_2q(lines: List[str], U, q0: int, q1: int) -> float:
    """Generic 2q gate via KAK; returns accumulated global phase."""
    gp, (g0, g1), (a, b, c), (g2, g3) = kak_decompose(U)
    total = gp
    # inner locals first (rightmost factor acts first)
    total += _emit_1q(lines, g0, q0)
    total += _emit_1q(lines, g1, q1)
    # exp(i a XX): conjugate ZZ by H on both
    if abs(a) > 1e-12:
        lines.append(f"h q[{q0}];")
        lines.append(f"h q[{q1}];")
        total += _emit_zz(lines, a, q0, q1)
        lines.append(f"h q[{q0}];")
        lines.append(f"h q[{q1}];")
    # exp(i b YY) = (Rx(pi/2) (x) Rx(pi/2)) exp(i b ZZ) (Rx(-pi/2) (x)
    # Rx(-pi/2)): rotation about X maps Z -> -Y at pi/2, signs cancel in
    # the two-site product.  Circuit order: earlier line = rightmost
    # factor, so Rx(-pi/2) = u3(pi/2, pi/2, -pi/2) is emitted FIRST.
    if abs(b) > 1e-12:
        for q in (q0, q1):
            lines.append(f"u3({math.pi / 2:.17g},{math.pi / 2:.17g},{-math.pi / 2:.17g}) q[{q}];")
        total += _emit_zz(lines, b, q0, q1)
        for q in (q0, q1):
            lines.append(f"u3({math.pi / 2:.17g},{-math.pi / 2:.17g},{math.pi / 2:.17g}) q[{q}];")
    # exp(i c ZZ)
    if abs(c) > 1e-12:
        total += _emit_zz(lines, c, q0, q1)
    total += _emit_1q(lines, g2, q0)
    total += _emit_1q(lines, g3, q1)
    return total


def to_openqasm(ops: Iterable[Op], n: int) -> Tuple[str, float]:
    """Serialize an op list to OpenQASM 2.0.  Returns (qasm_text,
    global_phase): circuit_unitary(ops) = e^{i global_phase} * U(qasm).

    Gates must act on 1 or 2 qubits (every circuit in the package does:
    ansatz zoo, TDVP/Loschmidt 6-qubit circuits, hardware natives)."""
    lines = [
        "OPENQASM 2.0;",
        'include "qelib1.inc";',
        f"qreg q[{n}];",
    ]
    phase = 0.0
    for U, wires in ops:
        U = np.asarray(U, dtype=complex)
        if len(wires) == 1:
            phase += _emit_1q(lines, U, wires[0])
        elif len(wires) == 2:
            phase += _emit_2q(lines, U, wires[0], wires[1])
        else:
            raise ValueError(
                f"OpenQASM export supports 1- and 2-qubit gates, got {len(wires)}"
            )
    return "\n".join(lines) + "\n", float(phase)


# ---------------------------------------------------------------------------
# round-trip parser (the subset we emit + common qelib1 gates)
# ---------------------------------------------------------------------------


def _eval_param(expr: str) -> float:
    """Safely evaluate a QASM angle expression (numbers, pi, + - * / and
    unary minus — the qelib1 parameter grammar).  No ``eval``: externally
    produced QASM is untrusted input."""
    import ast

    node = ast.parse(expr, mode="eval").body

    def ev2(n):
        if isinstance(n, ast.BinOp):
            a, b = ev2(n.left), ev2(n.right)
            if isinstance(n.op, ast.Add):
                return a + b
            if isinstance(n.op, ast.Sub):
                return a - b
            if isinstance(n.op, ast.Mult):
                return a * b
            if isinstance(n.op, ast.Div):
                return a / b
            raise ValueError(f"unsupported operator in: {expr!r}")
        if isinstance(n, ast.UnaryOp) and isinstance(n.op, (ast.UAdd, ast.USub)):
            v = ev2(n.operand)
            return -v if isinstance(n.op, ast.USub) else v
        if isinstance(n, ast.Constant) and isinstance(n.value, (int, float)):
            return float(n.value)
        if isinstance(n, ast.Name) and n.id == "pi":
            return math.pi
        raise ValueError(f"unsupported QASM parameter expression: {expr!r}")

    return float(ev2(node))


def parse_openqasm(text: str) -> Tuple[List[Op], int]:
    """Parse the emitted OpenQASM subset back into an op list (round-trip
    verification, and an import path for externally produced u3/cx
    circuits)."""
    import re

    n = 0
    ops: List[Op] = []
    for raw in text.splitlines():
        line = raw.strip()
        if not line or line.startswith(("OPENQASM", "include", "//")):
            continue
        m = re.match(r"qreg\s+\w+\[(\d+)\];", line)
        if m:
            n = int(m.group(1))
            continue
        m = re.match(r"u3\(([^)]*)\)\s+\w+\[(\d+)\];", line)
        if m:
            th, ph, la = [_eval_param(x) for x in m.group(1).split(",")]
            ops.append((_u3(th, ph, la), (int(m.group(2)),)))
            continue
        m = re.match(r"h\s+\w+\[(\d+)\];", line)
        if m:
            ops.append((_H.astype(complex), (int(m.group(1)),)))
            continue
        m = re.match(r"cx\s+\w+\[(\d+)\],\s*\w+\[(\d+)\];", line)
        if m:
            ops.append((_CX.astype(complex), (int(m.group(1)), int(m.group(2)))))
            continue
        raise ValueError(f"unsupported OpenQASM line: {line!r}")
    return ops, n
