"""Uniform (infinite) Matrix Product Operators and MPO-driven VUMPS and
TDVP (counterpart of ``qmps_tpu.mps.mpo``).

The reference's classical baseline drives xmps with an MPO Hamiltonian
(``xmps.tdvp.tdvp_fast.MPO_TFI``, qmps/loschmidts/mps_loschmidts.py:3).
Besides nearest-neighbour models an MPO holds any finite-range
interaction (the next-nearest-neighbour Ising chain below) and
exponentially decaying couplings (a diagonal ``lam * I`` interior block),
neither of which has a two-site ``h``.

Representation: a Schur-form (upper-triangular) uniform MPO tensor
``W[a, b]`` of d x d blocks with ``W[0, 0] = W[chi-1, chi-1] = I``; the
Hamiltonian is the sum over all placements of strings that start in row
0 and end in column chi-1.  ``W`` is a host numpy array; each MPO keeps
its nonzero blocks as tensors once per device and type (``_blocks``).

Environments: the triangular recursion (Zauner-Stauber et al., PRB 97,
045145, App. C).  With AL left-canonical and r its right fixed point, the
left block environments L_a (D x D) satisfy

    L_b = sum_{a<=b, s, t}  AL_s^dag L_a W[a, b, s, t] AL_t ,

solved down the triangle: L_0 = I; a strictly triangular interior
component is a direct sum; an interior component with W[b, b] != 0 is a
nonsingular dense (D^2, D^2) solve; the last component is the singular
geometric sum regularized by the energy-density subtraction,
``tdvp._solve_left_env``.  Right environments mirror it with AR and l.
The recursion is a host loop over the MPO's (fixed) bond dimension.
"""
from __future__ import annotations

import numpy as np
import torch

from ..config import resolve_device
from ..core.linalg import _trace
from .tdvp import (
    _auto_solver,
    _euler_step,
    _eye,
    _lanczos_ground,
    _pinv,
    _regauge,
    _rk4_step,
    _solve,
    _solve_left_env,
    _solve_right_env,
    _true_r,
    _vumps_iterate,
    _working_dtype,
    mixed_gauge,
)

__all__ = [
    "MPO",
    "mpo_tfim",
    "mpo_heisenberg",
    "mpo_xxz",
    "mpo_nnn_ising",
    "mpo_exp_decay",
    "mpo_from_two_site",
    "mpo_environments",
    "energy_mpo",
    "effective_H_AC_mpo",
    "effective_H_C_mpo",
    "dAC_dC_dt_mpo",
    "tdvp_step_mpo",
    "tdvp_step_rk4_mpo",
    "vumps_ground_state_mpo",
]


def _pauli(name: str) -> np.ndarray:
    from ..core.paulis import PAULI

    return PAULI[name].numpy()


class MPO:
    """Schur-form uniform MPO: ``W[a, b, s, t]`` host numpy, upper
    triangular in (a, b) with identity corner blocks.

    ``W[a, b]`` is the d x d operator block from left bond state a to
    right bond state b; ``s`` is the output (bra) physical index and ``t``
    the input (ket) index, so a block equals its operator matrix.
    """

    def __init__(self, W):
        W = np.asarray(W)
        if W.ndim != 4 or W.shape[0] != W.shape[1] or W.shape[2] != W.shape[3]:
            raise ValueError(f"W must be (chi, chi, d, d), got {W.shape}")
        chi, _, d, _ = W.shape
        if chi < 2:
            # a chi = 1 tensor has no (row-0 -> column chi-1) string channel
            raise ValueError(f"Schur-form MPO needs chi >= 2 bond states, got chi={chi}")
        eye = np.eye(d)
        for corner in (0, chi - 1):
            if not np.allclose(W[corner, corner], eye, atol=1e-12):
                raise ValueError("Schur form requires identity corner blocks")
        tril = [(a, b) for a in range(chi) for b in range(a) if np.any(np.abs(W[a, b]) > 1e-14)]
        if tril:
            raise ValueError(f"W must be upper triangular, nonzero at {tril}")
        # an interior diagonal block drives a geometric environment sum
        # solved without the rank-1 deflation of the corners: singular when
        # its spectral radius is >= 1 (W[1,1] = I, a non-decaying
        # infinite-range coupling), where the solve returns non-finite
        # values without a word.  Reject it here.
        for b in range(1, chi - 1):
            rad = np.max(np.abs(np.linalg.eigvals(W[b, b])))
            if rad >= 1.0 - 1e-12:
                raise ValueError(
                    f"interior diagonal block W[{b},{b}] has spectral radius {rad:.6f} >= 1: the "
                    "geometric environment sum diverges (only decaying interior strings are "
                    "representable; see mpo_exp_decay's |lam| < 1 rule)"
                )
        self.W = W.astype(np.complex128)
        self._device_blocks = {}

    @property
    def chi(self) -> int:
        return self.W.shape[0]

    @property
    def d(self) -> int:
        return self.W.shape[2]

    def _blocks(self, like: torch.Tensor):
        """W's blocks as tensors of like's device and type (None where
        zero), made once per device and type."""
        key = (like.device, like.dtype)
        if key not in self._device_blocks:
            chi = self.chi
            blocks = [[None] * chi for _ in range(chi)]
            for a in range(chi):
                for b in range(a, chi):
                    if np.any(np.abs(self.W[a, b]) > 1e-14):
                        blocks[a][b] = torch.from_numpy(self.W[a, b]).to(like.device, like.dtype)
            self._device_blocks[key] = blocks
        return self._device_blocks[key]

    def matrix(self, n: int) -> np.ndarray:
        """Dense n-site Hamiltonian (open boundary, every string placement
        that fits in the window): the small-window oracle of the
        environment recursion."""
        chi, d = self.chi, self.d
        cur = {0: np.eye(1)}
        for _ in range(n):
            nxt = {}
            for a, op in cur.items():
                for b in range(a, chi):
                    blk = self.W[a, b]
                    if not np.any(np.abs(blk) > 1e-14):
                        continue
                    term = np.kron(op, blk)
                    nxt[b] = term if b not in nxt else nxt[b] + term
            cur = nxt
        # no string ends inside the window (a field-free nearest-neighbour
        # MPO at n = 1): the zero operator
        return cur.get(chi - 1, np.zeros((d ** n, d ** n), np.complex128))

    def two_site_matrix(self) -> np.ndarray:
        """Dense bond Hamiltonian h with H = sum_n h_{n,n+1}: exact for MPOs
        whose strings have range <= 2 (no interior-to-interior blocks);
        raises for longer-range ones rather than dropping their strings.
        On-site strings (the W[0, chi-1] corner) are split half and half
        across the bond, as ``ham.Hamiltonian.to_matrix`` splits them, so
        ``mpo_from_two_site(h).two_site_matrix() == h``."""
        chi, d = self.chi, self.d
        W = self.W
        long_range = [(a, b) for a in range(1, chi - 1) for b in range(a, chi - 1)
                      if np.any(np.abs(W[a, b]) > 1e-14)]
        if long_range:
            raise ValueError(
                f"MPO has interior-to-interior blocks at {long_range}: its strings have range >= 3 "
                "and cannot be written as a two-site bond Hamiltonian; use the MPO-native evolution "
                "path (mps.tdvp.Trajectory(A0, h=mpo)) instead"
            )
        eye = np.eye(d)
        h = np.zeros((d * d, d * d), np.complex128)
        for k in range(1, chi - 1):
            h += np.kron(W[0, k], W[k, chi - 1])
        f = W[0, chi - 1]
        return h + 0.5 * (np.kron(f, eye) + np.kron(eye, f))


def mpo_tfim(g: float, J: float = 1.0) -> MPO:
    """TFIM  H = -J sum Z_i Z_{i+1} - g sum X_i  (the xmps ``MPO_TFI``).

    The field carries the textbook -g X, where ``ham.tfim(g)`` carries
    +g X: pass g -> -g for parity with ``ham.tfim`` (the two are unitarily
    equivalent under Z conjugation, so energies agree either way)."""
    I, X, Z = _pauli("I"), _pauli("X"), _pauli("Z")
    W = np.zeros((3, 3, 2, 2), np.complex128)
    W[0, 0] = I
    W[2, 2] = I
    W[0, 1] = Z
    W[1, 2] = -J * Z
    W[0, 2] = -g * X
    return MPO(W)


def mpo_from_two_site(h) -> MPO:
    """Exact MPO of a two-site Hamiltonian h[(uv), (st)] by its
    operator-Schmidt (SVD) decomposition h = sum_k O_k (x) P_k: chi = 2 +
    rank <= 6 for d = 2, and energies identical to the two-site path."""
    h = np.asarray(h, np.complex128)
    d = int(round(h.shape[0] ** 0.5))
    hk = h.reshape(d, d, d, d).transpose(0, 2, 1, 3).reshape(d * d, d * d)
    u, s, vh = np.linalg.svd(hk)
    rank = int(np.sum(s > 1e-12 * s[0]))
    chi = rank + 2
    W = np.zeros((chi, chi, d, d), np.complex128)
    eye = np.eye(d)
    W[0, 0] = eye
    W[chi - 1, chi - 1] = eye
    for k in range(rank):
        W[0, 1 + k] = (u[:, k] * s[k]).reshape(d, d)
        W[1 + k, chi - 1] = vh[k].reshape(d, d)
    return MPO(W)


def mpo_heisenberg(J: float = 1.0) -> MPO:
    """Isotropic Heisenberg H = J sum (XX + YY + ZZ)."""
    return mpo_xxz(delta=1.0, J=J)


def mpo_xxz(delta: float, J: float = 1.0) -> MPO:
    """XXZ  H = J sum (XX + YY + delta ZZ), chi = 5."""
    I = _pauli("I")
    W = np.zeros((5, 5, 2, 2), np.complex128)
    W[0, 0] = I
    W[4, 4] = I
    for k, (op, coef) in enumerate(((_pauli("X"), J), (_pauli("Y"), J), (_pauli("Z"), J * delta))):
        W[0, 1 + k] = op
        W[1 + k, 4] = coef * op
    return MPO(W)


def mpo_nnn_ising(g: float, J2: float, J1: float = 1.0) -> MPO:
    """Next-nearest-neighbour Ising
    H = -J1 sum Z_i Z_{i+1} - J2 sum Z_i Z_{i+2} - g sum X_i  (chi = 4):
    the minimal model with no two-site ``h``."""
    I, X, Z = _pauli("I"), _pauli("X"), _pauli("Z")
    W = np.zeros((4, 4, 2, 2), np.complex128)
    W[0, 0] = I
    W[3, 3] = I
    W[0, 1] = Z
    W[1, 2] = I  # carry Z one more site for the J2 string
    W[1, 3] = -J1 * Z
    W[2, 3] = -J2 * Z
    W[0, 3] = -g * X
    return MPO(W)


def mpo_exp_decay(op_l, op_r, lam: float, prefactor: float = 1.0, field=None) -> MPO:
    """Exponentially decaying two-body coupling
    H = prefactor sum_{i<j} lam^(j-i-1) op_l_i op_r_j  (+ an on-site field),
    chi = 3 with the interior block W[1,1] = lam I (|lam| < 1)."""
    if not abs(lam) < 1:
        raise ValueError("exp-decay MPO needs |lam| < 1")
    op_l = np.asarray(op_l, np.complex128)
    op_r = np.asarray(op_r, np.complex128)
    d = op_l.shape[0]
    W = np.zeros((3, 3, d, d), np.complex128)
    eye = np.eye(d)
    W[0, 0] = eye
    W[2, 2] = eye
    W[0, 1] = op_l
    W[1, 1] = lam * eye
    W[1, 2] = prefactor * op_r
    if field is not None:
        W[0, 2] = np.asarray(field, np.complex128)
    return MPO(W)


# ---------------------------------------------------------------------------
# Block environments
# ---------------------------------------------------------------------------


def _apply_left(AL, X, blk):
    """sum_{s,t} AL_s^dag X blk[s, t] AL_t: one site of the left recursion
    through one W block."""
    return torch.einsum("sia,sib->ab", AL.conj(), torch.einsum("st,tib->sib", blk, X @ AL))


def _apply_right(AR, X, blk):
    """sum_{s,t} blk[s, t] AR_t X AR_s^dag; index order (ket, bra), the
    right recursion's convention."""
    return torch.einsum("saj,sbj->ab", torch.einsum("st,taj->saj", blk, AR @ X), AR.conj())


def _solve_interior_left(AL, blk, rhs):
    """L solving L - sum_{s,t} blk[s,t] AL_s^dag L AL_t = rhs: the
    nonsingular interior geometric sum (the blk-weighted transfer has
    spectral radius < 1 for a valid Schur MPO).  Dense (D^2, D^2)."""
    D = AL.shape[1]
    T = torch.einsum("st,sia,tjb->abij", blk, AL.conj(), AL).reshape(D * D, D * D)
    return _solve(_eye(D * D, AL) - T, rhs.reshape(-1)).reshape(D, D)


def _solve_interior_right(AR, blk, rhs):
    D = AR.shape[1]
    T = torch.einsum("st,tai,sbj->abij", blk, AR, AR.conj()).reshape(D * D, D * D)
    return _solve(_eye(D * D, AR) - T, rhs.reshape(-1)).reshape(D, D)


def _left_inflow(AL, Ls, blocks, b):
    """sum_{a<b} of W[a, b] applied to L_a: what flows into component b."""
    rhs = torch.zeros_like(Ls[0])
    for a in range(b):
        if blocks[a][b] is not None:
            rhs = rhs + _apply_left(AL, Ls[a], blocks[a][b])
    return rhs


def mpo_environments(AL, AR, C, mpo: MPO, env_solver: str = "dense"):
    """(Ls, Rs, e): the stacked left and right MPO block environments
    (chi, D, D) and the energy density.

    Ls[a][i, j]: i contracts the bra layer, j the ket layer; Rs[b][i, j]:
    i the ket layer, j the bra layer.  The extensive part is subtracted
    from both singular components (Ls[-1], Rs[0]), which makes the
    effective Hamiltonians below connected."""
    D = AL.shape[1]
    blocks = mpo._blocks(AL)
    chi = mpo.chi
    r = C @ C.mH
    l = C.mH @ C
    eye = _eye(D, AL)

    Ls = [eye] + [None] * (chi - 1)
    for b in range(1, chi):
        rhs = _left_inflow(AL, Ls, blocks, b)
        if b < chi - 1:
            Ls[b] = rhs if blocks[b][b] is None else _solve_interior_left(AL, blocks[b][b], rhs)
        else:
            e = _trace(rhs @ r).real
            Ls[b] = _solve_left_env(AL, r, rhs - e.to(rhs.dtype) * eye, solver=env_solver)

    Rs = [None] * (chi - 1) + [eye]
    for a in range(chi - 2, -1, -1):
        rhs = torch.zeros_like(eye)
        for b in range(a + 1, chi):
            if blocks[a][b] is not None:
                rhs = rhs + _apply_right(AR, Rs[b], blocks[a][b])
        if a > 0:
            Rs[a] = rhs if blocks[a][a] is None else _solve_interior_right(AR, blocks[a][a], rhs)
        else:
            eR = _trace(l @ rhs).real
            Rs[a] = _solve_right_env(AR, l, rhs - eR.to(rhs.dtype) * eye, solver=env_solver)
    return torch.stack(Ls), torch.stack(Rs), e


def energy_mpo(AL, C, mpo: MPO) -> torch.Tensor:
    """Energy density of a left-canonical uMPS under the MPO: the inflow
    into the singular left component, tr(rhs_{chi-1} r), r = C C^dag.
    Equals ``tdvp.energy_density(AL, C, h)`` for a two-site model written
    as an MPO."""
    return _energy_mpo_at(AL, C @ C.mH, mpo)


def _energy_mpo_at(AL, r, mpo: MPO) -> torch.Tensor:
    """``energy_mpo`` at the right fixed point r itself."""
    blocks = mpo._blocks(AL)
    chi = mpo.chi
    Ls = [_eye(AL.shape[1], AL)] + [None] * (chi - 1)
    for b in range(1, chi - 1):
        rhs = _left_inflow(AL, Ls, blocks, b)
        Ls[b] = rhs if blocks[b][b] is None else _solve_interior_left(AL, blocks[b][b], rhs)
    return _trace(_left_inflow(AL, Ls, blocks, chi - 1) @ r).real


def effective_H_AC_mpo(x, Ls, Rs, mpo: MPO, e=None):
    """MPO one-site effective Hamiltonian applied to x (d, D, D):

        (H_AC x)[s, p, q] = sum_{a,b,t} Ls[a][p, p'] W[a,b,s,t] x[t, p', q'] Rs[b][q', q]

    With ``e`` given, the on-site corner block W[0, chi-1] is shifted by
    -e I: the connected effective Hamiltonian (the analogue of
    ``tdvp.dAC_dC_dt``'s h - e), for which H_AC(AC) = AL H_C(C) at a
    variational optimum."""
    blocks = mpo._blocks(x)
    chi = mpo.chi
    out = torch.zeros_like(x)
    for a in range(chi):
        for b in range(a, chi):
            blk = blocks[a][b]
            if a == 0 and b == chi - 1 and e is not None:
                shift = e.to(x.dtype) * _eye(mpo.d, x)
                blk = -shift if blk is None else blk - shift
            if blk is None:
                continue
            out = out + torch.einsum("st,tpq->spq", blk, Ls[a] @ x @ Rs[b])
    return out


def effective_H_C_mpo(C, Ls, Rs):
    """(H_C x)[p, q] = sum_a Ls[a][p, p'] x[p', q'] Rs[a][q', q]."""
    return (Ls @ C @ Rs).sum(0)


def dAC_dC_dt_mpo(AL, AR, C, mpo: MPO, env_solver: str = "dense"):
    """(-i H_AC(AC), -i H_C(C), e): the MPO tangent flow, phase-free like
    ``tdvp.dAC_dC_dt``.  The expectation <AC|H_AC|AC> (<C|H_C|C>) is
    subtracted from each flow, which for a two-site model equals the 2e
    (e) shift of the h - e convention exactly; for a general MPO the
    count of string placements through the center site depends on the
    range, so the subtraction is the measured expectation."""
    AC = AL @ C
    Ls, Rs, e = mpo_environments(AL, AR, C, mpo, env_solver=env_solver)
    gAC = effective_H_AC_mpo(AC, Ls, Rs, mpo)
    gC = effective_H_C_mpo(C, Ls, Rs)
    lam_AC = torch.vdot(AC.reshape(-1), gAC.reshape(-1)).real / torch.vdot(AC.reshape(-1), AC.reshape(-1)).real
    lam_C = torch.vdot(C.reshape(-1), gC.reshape(-1)).real / torch.vdot(C.reshape(-1), C.reshape(-1)).real
    return -1j * (gAC - lam_AC * AC), -1j * (gC - lam_C * C), e


def _tangent_mpo(mpo: MPO, env_solver: str = "dense"):
    """tangent(AL, C) -> (dAC, dC, e) under an MPO: the twin of
    ``tdvp._tangent_dense``, for the shared steppers and for
    ``tdvp.Trajectory(A0, h=mpo)``."""
    def tangent(AL, C):
        AR = _pinv(C) @ AL @ C
        return dAC_dC_dt_mpo(AL, AR, C, mpo, env_solver=env_solver)

    return tangent


def tdvp_step_mpo(AL, C, mpo: MPO, dt: float, env_solver: str = "dense"):
    """One explicit-Euler TDVP step under an MPO (the polar retraction is
    the dense path's)."""
    return _euler_step(AL, C, dt, _tangent_mpo(mpo, env_solver))


def tdvp_step_rk4_mpo(AL, C, mpo: MPO, dt: float, env_solver: str = "dense"):
    """One classical-RK4 TDVP step under an MPO (``tdvp.tdvp_step_rk4``)."""
    return _rk4_step(AL, C, dt, _tangent_mpo(mpo, env_solver))


def dA_dt_mpo(A, mpo: MPO):
    """Tangent vector of a left-canonical tensor A under an MPO
    (``tdvp.dA_dt`` with the MPO's environments)."""
    AL, AR, C = mixed_gauge(A)
    dAC, dC, _ = dAC_dC_dt_mpo(AL, AR, C, mpo)
    return (dAC - AL @ dC) @ _pinv(C)


def vumps_step_mpo(AL, AR, C, mpo: MPO, k: int = 24, env_solver: str = "dense"):
    """One MPO-VUMPS iteration (``tdvp.vumps_step`` with the MPO's
    environments).  Returns (AL, AR, C, e, grad_norm)."""
    d, D, _ = AL.shape
    Ls, Rs, e = mpo_environments(AL, AR, C, mpo, env_solver=env_solver)
    AC = AL @ C

    gAC = effective_H_AC_mpo(AC, Ls, Rs, mpo, e=e)
    gC = effective_H_C_mpo(C, Ls, Rs)
    grad_norm = torch.linalg.vector_norm(gAC - AL @ gC)

    _, ac = _lanczos_ground(lambda x: effective_H_AC_mpo(x.reshape(d, D, D), Ls, Rs, mpo, e=e).reshape(-1),
                            AC.reshape(-1), k)
    _, c = _lanczos_ground(lambda x: effective_H_C_mpo(x.reshape(D, D), Ls, Rs).reshape(-1), C.reshape(-1), k)
    return (*_regauge(ac.reshape(d, D, D), c.reshape(D, D)), e, grad_norm)


@torch.no_grad()
def vumps_ground_state_mpo(mpo: MPO, D: int, iters: int = 150, k: int = 24,
                           generator: torch.Generator | None = None, A0=None, env_solver: str = "auto",
                           device=None):
    """Ground state of an MPO Hamiltonian by VUMPS: the twin of
    ``tdvp.vumps_ground_state``, with its contract: (AL, C, energy, info),
    the energy at the returned AL's true fixed point.  Models beyond the
    two-site plumbing: NNN Ising, exponentially decaying couplings,
    anything in Schur form.  The precision is A0's, else the device's."""
    device = resolve_device(device, A0)
    cdtype = _working_dtype(device, A0)
    if A0 is None:
        from .imps import random_tensor

        if generator is None:
            generator = torch.Generator().manual_seed(0)
        A0 = random_tensor(generator, mpo.d, D, cdtype, device)
    env_solver = _auto_solver(env_solver, D)
    (AL, _, C), es, gs = _vumps_iterate(mixed_gauge(torch.as_tensor(A0).to(device, cdtype)),
                                        lambda *st: vumps_step_mpo(*st, mpo, k, env_solver=env_solver), iters)
    # the energy at the returned AL's true right fixed point (the
    # in-iteration estimator assumes C C^dag is it: true only at
    # convergence), read at the unit-trace r itself: the JAX package reads
    # it through C = chol(r + 32 eps I), whose C C^dag has trace 1 + 32 D
    # eps, which in float32 moves the energy by ~1e-5 (ROADMAP.md section 3)
    e = _energy_mpo_at(AL, _true_r(AL), mpo)
    return AL, C, float(e), {"grad_norms": gs, "energies": es}
