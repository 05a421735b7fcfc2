"""Uniform MPS (counterpart of ``qmps_tpu.mps.imps``).

Random states, the left and right canonical forms (1-site and n-site
cells), the mixed gauge, Schmidt values, entropy and truncation, one- and
two-site expectation values, correlators, the correlation length and the
static structure factor, overlaps, the energy variance and the TDVP
tangent ``dA_dt`` (mps/tdvp); ``Map`` and ``TransferMatrix``.  A tensor
A has shape (d, D, D) = (physical, left, right).  ``merge``, the 1-site
canonical forms and ``E2`` of a one-tensor cell broadcast over leading
dimensions (the scars ensemble's energies); the rest takes one state.

Every fixed point enters a gauge or an observable rotated to hermitian,
then hermitized and given unit trace (``_unit_trace_herm``).  A squaring
solve leaves it with an arbitrary global phase; near pi/2 the plain
average (r + r^dag)/2, which the JAX package takes, cancels it.
"""
from __future__ import annotations

from typing import Sequence

import torch
from torch.autograd.function import once_differentiable

from ..config import CDTYPE, resolve_device
from ..core.linalg import dominant_eig_dense, rotate_to_hermitian, spectral_radius_dense
from . import transfer as tr


def merge(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Block two site tensors into one (..., d1 d2, D, D) tensor
    (qmps/time_evolve_tools.py:20-23)."""
    AB = torch.einsum("...sik,...tkj->...stij", A, B)
    return AB.reshape(AB.shape[:-4] + (A.shape[-3] * B.shape[-3], A.shape[-2], B.shape[-1]))


def _trace(m: torch.Tensor) -> torch.Tensor:
    return m.diagonal(dim1=-2, dim2=-1).sum(-1)


def _cholesky_psd(M: torch.Tensor) -> torch.Tensor:
    """Cholesky of a hermitian PSD matrix with a jitter of 32 eps tr(M),
    eps the type's: a fixed jitter far below complex64's resolution cannot
    lift the roundoff eigenvalues (~ -1e-8) of a rank-deficient fixed point,
    and the factorization fails (imps.py:42-52)."""
    M = (M + M.mH) / 2
    eps = 32 * torch.finfo(M.real.dtype).eps * _trace(M).real
    return torch.linalg.cholesky(M + eps[..., None, None] * torch.eye(M.shape[-1], dtype=M.dtype, device=M.device))


def _qr_pos(mat: torch.Tensor):
    """QR with the diagonal of R rotated positive-real: a deterministic
    gauge (the complex QR phase ambiguity otherwise makes canonical forms
    seed-dependent)."""
    Q, R = torch.linalg.qr(mat)
    dg = torch.diagonal(R)
    tiny = torch.finfo(dg.real.dtype).tiny
    ph = dg / torch.where(dg.abs() > tiny, dg.abs(), torch.ones_like(dg.abs()))
    return Q * ph[None, :], R * ph.conj()[:, None]


class _PinvTri(torch.autograd.Function):
    """The cut SVD pseudo-inverse with the adjoint of the pseudo-inverse
    itself, d(M+) = -M+ dM M+ + M+ M+^dag dM^dag (I - M M+) + (I - M+ M)
    dM^dag M+^dag M+ (constant rank, Golub and Pereyra), in place of the
    SVD's adjoint, whose 1/(s_i^2 - s_j^2) is 0/0 at degenerate singular
    values: a left-canonical tensor's gauge matrix is a multiple of the
    identity (the scars tensors, ``algorithms/scars``), where the JAX
    package's gradient is NaN."""

    @staticmethod
    def forward(ctx, M, rcond):
        u, s, vh = torch.linalg.svd(M, full_matrices=False)
        cut = rcond * s[..., :1]
        sinv = torch.where(s > cut, 1.0 / torch.maximum(s, cut), torch.zeros_like(s))
        Y = vh.mH @ (sinv[..., :, None].to(M.dtype) * u.mH)
        ctx.save_for_backward(M, Y)
        return Y

    @staticmethod
    @once_differentiable
    def backward(ctx, G):
        M, Y = ctx.saved_tensors
        eye_m = torch.eye(M.shape[-2], dtype=M.dtype, device=M.device)
        eye_n = torch.eye(M.shape[-1], dtype=M.dtype, device=M.device)
        Gh = G.mH
        return (-Y.mH @ G @ Y.mH + (eye_m - M @ Y) @ Gh @ Y @ Y.mH
                + Y.mH @ Y @ Gh @ (eye_n - Y @ M)), None


def _pinv_tri(M: torch.Tensor, rcond: float | None = None) -> torch.Tensor:
    """SVD pseudo-inverse of a gauge matrix with a relative cutoff, by
    default eps**0.75 of the type (~7e-6 in float32, ~1e-12 in float64):
    the null directions of a rank-deficient gauge matrix are dropped
    instead of inverted (imps.py:66-82).  Differentiated as a
    pseudo-inverse (``_PinvTri``)."""
    if rcond is None:
        rcond = float(torch.finfo(M.real.dtype).eps) ** 0.75
    return _PinvTri.apply(M, rcond)


def _unit_trace_herm(x: torch.Tensor) -> torch.Tensor:
    """A fixed point that is hermitian up to a global phase as a unit-trace
    hermitian matrix: the phase is removed before the average."""
    x = rotate_to_hermitian(x)
    x = (x + x.mH) / 2
    return x / _trace(x)[..., None, None]


def random_tensor(generator: torch.Generator | None = None, d: int = 2, D: int = 2,
                  dtype=CDTYPE, device=None) -> torch.Tensor:
    """(d, D, D) tensor of complex normals drawn from ``generator`` on the
    CPU; ``device`` as ``config.resolve_device`` (the card unless asked)."""
    device = resolve_device(device)
    x = torch.randn(2, d, D, D, generator=generator, dtype=torch.float64)
    return torch.complex(x[0], x[1]).to(device, dtype)


def left_orthogonalise(A: torch.Tensor, dense: bool = True):
    """Gauge A to left-canonical form.

    Returns (AL, L_upper, eta): sum AL^dag AL = I, where l = L^dag L is the
    dominant left fixed point of the transfer operator and eta its
    eigenvalue (the state's norm per site before rescaling).
    """
    eta, l = tr.left_fixed_point(A, A, dense=dense)
    M = _cholesky_psd(_unit_trace_herm(l)).mH  # upper; l = M^dag M
    AL = torch.einsum("...ij,...sjk,...kl->...sil", M, A, _pinv_tri(M)) / torch.sqrt(eta.real)[..., None, None, None]
    return AL, M, eta


def right_orthogonalise(A: torch.Tensor, dense: bool = True):
    """Gauge A to right-canonical form: returns (AR, C, eta) with
    sum AR AR^dag = I and r = C C^dag the dominant right fixed point."""
    eta, r = tr.right_fixed_point(A, A, dense=dense)
    C = _cholesky_psd(_unit_trace_herm(r))
    AR = torch.einsum("...ij,...sjk,...kl->...sil", _pinv_tri(C), A, C) / torch.sqrt(eta.real)[..., None, None, None]
    return AR, C, eta


def _expect(op: torch.Tensor, A: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """sum op[t, s] tr(A[s] r A[t]^dag): op's BRA index t pairs with the
    conjugated tensor (the "st" order computes <op^T>, wrong for Y)."""
    op = torch.as_tensor(op).to(A.device, A.dtype)
    return torch.einsum("...ts,...sij,...jk,...tik->...", op, A, r, A.conj())


class iMPS:
    """Uniform MPS with a (usually 1-site) unit cell, xmps-compatible API."""

    def __init__(self, data: Sequence[torch.Tensor] | None = None):
        self.data = tuple(torch.as_tensor(a) for a in data) if data is not None else ()

    def __getitem__(self, i):
        return self.data[i]

    def __len__(self):
        return len(self.data)

    @classmethod
    def random(cls, generator: torch.Generator | None = None, d: int = 2, D: int = 2, n: int = 1,
               dtype=CDTYPE, device=None) -> "iMPS":
        """n random site tensors (``random_tensor``), drawn in turn from
        ``generator``."""
        return cls([random_tensor(generator, d, D, dtype, device) for _ in range(n)])

    @property
    def blocked(self) -> torch.Tensor:
        """The unit cell merged into a single site tensor."""
        A = self.data[0]
        for B in self.data[1:]:
            A = merge(A, B)
        return A

    @property
    def d(self):
        return self.data[0].shape[0]

    @property
    def D(self):
        return self.data[0].shape[1]

    def left_canonicalise(self) -> "iMPS":
        """Per-site left-canonical form: an n-site cell returns n tensors,
        each with sum_s A_i[s]^dag A_i[s] = I: one boundary fixed-point
        solve, then a QR sweep through the cell (imps.py:164-190)."""
        if len(self.data) == 1:
            AL, _, _ = left_orthogonalise(self.data[0])
            return iMPS([AL])
        A0 = self.blocked
        _, l = tr.left_fixed_point(A0, A0)
        M = _cholesky_psd(_unit_trace_herm(l)).mH  # l = M^dag M, the cell-boundary gauge
        ALs = []
        for A in self.data:
            B = torch.einsum("ij,sjk->sik", M, A)
            d, Dl, Dr = B.shape
            Q, R = _qr_pos(B.reshape(d * Dl, Dr))
            ALs.append(Q.reshape(d, Dl, Dr))
            M = R
        return iMPS(ALs)

    def right_canonicalise(self) -> "iMPS":
        """Per-site right-canonical form, sum_s A_i[s] A_i[s]^dag = I: the
        mirror of ``left_canonicalise`` (one boundary fixed point, then an
        RQ sweep right to left; imps.py:192-215)."""
        if len(self.data) == 1:
            AR, _, _ = right_orthogonalise(self.data[0])
            return iMPS([AR])
        A0 = self.blocked
        _, r = tr.right_fixed_point(A0, A0)
        C = _cholesky_psd(_unit_trace_herm(r))  # r = C C^dag
        ARs = []
        for A in reversed(self.data):
            B = torch.einsum("sjk,kl->sjl", A, C)
            d, Dl, Dr = B.shape
            # RQ through the QR of the dagger: rows (Dl, d Dr)
            Q, R = _qr_pos(B.transpose(0, 1).reshape(Dl, d * Dr).mH)
            ARs.append(Q.mH.reshape(Dl, d, Dr).transpose(0, 1))
            C = R.mH
        return iMPS(list(reversed(ARs)))

    def mixed(self):
        """(AL, AR, C), the mixed gauge of the (blocked) state: AL C = C AR
        (xmps iMPS.mixed; qmps/tools.py:184-186)."""
        AL, _, _ = left_orthogonalise(self.blocked)
        C = _cholesky_psd(self._r(AL))  # r = C C^dag
        AR = torch.einsum("ij,sjk,kl->sil", _pinv_tri(C), AL, C)
        return AL, AR, C

    def schmidt_values(self) -> torch.Tensor:
        """The bipartition's Schmidt coefficients, descending: the
        normalised singular values of the mixed gauge's C."""
        s = torch.linalg.svdvals(self.mixed()[2])
        return s / torch.linalg.vector_norm(s)

    def entanglement_entropy(self) -> torch.Tensor:
        """Half-chain entropy -sum s^2 log s^2; the log's floor is the
        type's tiny, so an exact zero adds 0, not NaN, in float32 too."""
        s2 = self.schmidt_values() ** 2
        return -torch.sum(s2 * torch.log(s2.clamp(min=torch.finfo(s2.dtype).tiny)))

    def truncated(self, D_new: int):
        """(state, kept weight): the state cut to bond dimension D_new by
        keeping the D_new largest Schmidt vectors (AL projected onto the
        leading left singular vectors of C, then left-canonicalised); the
        weight is the sum of the kept squared Schmidt coefficients."""
        AL, _, C = self.mixed()
        U, s, _ = torch.linalg.svd(C)
        s2 = (s / torch.linalg.vector_norm(s)) ** 2
        P = U[:, :D_new]
        A_new = torch.einsum("ij,sjk,kl->sil", P.mH, AL, P)
        return iMPS([A_new]).left_canonicalise(), torch.sum(s2[:D_new])

    # observables ------------------------------------------------------------
    @staticmethod
    def _r(AL: torch.Tensor) -> torch.Tensor:
        return _unit_trace_herm(tr.right_fixed_point(AL, AL)[1])

    def E(self, op: torch.Tensor, canonical: bool = True) -> torch.Tensor:
        """Single-site expectation value <psi|op|psi> per site."""
        AL = left_orthogonalise(self.blocked)[0] if canonical else self.blocked
        return _expect(op, AL, self._r(AL))

    def Es(self, ops: Sequence[torch.Tensor]) -> torch.Tensor:
        """The real parts of ``E`` of each of ``ops``, from one gauge."""
        AL, _, _ = left_orthogonalise(self.blocked)
        r = self._r(AL)
        return torch.stack([_expect(op, AL, r).real for op in ops])

    def E2(self, op2: torch.Tensor) -> torch.Tensor:
        """Two-site expectation value of a (d^2, d^2) operator."""
        AL, _, _ = left_orthogonalise(self.blocked)
        return _expect(op2, merge(AL, AL), self._r(AL))

    def energy(self, h: torch.Tensor) -> torch.Tensor:
        return self.E2(h).real

    def energy_variance(self, h: torch.Tensor, env_solver: str = "dense") -> torch.Tensor:
        """Per-site energy variance (<H^2> - <H>^2)/N for H = sum h_{n,n+1}:
        zero iff the state is an exact eigenstate; the oracle-free
        convergence certificate (``tdvp.energy_variance_density``)."""
        from .tdvp import energy_variance_density

        AL, _, _ = left_orthogonalise(self.blocked)
        h = torch.as_tensor(h).to(AL.device, AL.dtype)
        return energy_variance_density(AL, self._r(AL), h, env_solver=env_solver)

    def correlation_length(self) -> torch.Tensor:
        """xi = -1 / log(|lambda_2| / |lambda_1|) of the transfer spectrum:
        the dominant pair deflated with its left and right eigenvectors, and
        |lambda_2| the deflated matrix's spectral radius (Gelfand), which
        is right when lambda_2 is a complex-conjugate pair."""
        AL, _, _ = left_orthogonalise(self.blocked)
        E = tr.transfer_dense(AL, AL)
        lam1, v1, w1 = dominant_eig_dense(E, left=True)
        w1 = w1 / torch.vdot(w1, v1).conj()
        ratio = spectral_radius_dense(E - lam1 * torch.outer(v1, w1.conj())) / lam1.abs()
        fi = torch.finfo(ratio.dtype)
        return -1.0 / torch.log(ratio.clamp(fi.tiny, 1 - fi.eps))

    def correlator(self, op1, op2, max_dist: int = 20) -> torch.Tensor:
        """Connected two-point function C(r) = <O1_0 O2_r> - <O1><O2> for
        r = 1..max_dist, by repeated transfer application."""
        AL, _, _ = left_orthogonalise(self.blocked)
        r = self._r(AL)
        op1 = torch.as_tensor(op1).to(AL.device, AL.dtype)
        op2 = torch.as_tensor(op2).to(AL.device, AL.dtype)
        T = torch.einsum("ts,sij,jk,tlk->il", op2, AL, r, AL.conj())  # r with O2 inserted
        e1e2 = _expect(op1, AL, r) * _trace(T)
        cs = []
        for _ in range(max_dist):
            cs.append(_expect(op1, AL, T))
            T = tr.right_matvec(AL, AL, T)
        return (torch.stack(cs) - e1e2).real

    def static_structure_factor(self, op, p, max_dist: int = 60) -> torch.Tensor:
        """s(p) = sum_r e^{ipr} <O_0 O_r>_c for a hermitian O: C(0) = <O^2>
        - <O>^2 plus 2 sum_{r>=1} cos(pr) C(r) (C from ``correlator``)."""
        op = torch.as_tensor(op)
        Cr = self.correlator(op, op, max_dist=max_dist)
        e1 = self.E(op).real
        e2 = self.E(op @ op).real
        r = torch.arange(1, max_dist + 1, dtype=Cr.dtype, device=Cr.device)
        p = torch.as_tensor(p, dtype=Cr.dtype, device=Cr.device)
        return (e2 - e1 ** 2) + 2.0 * torch.sum(torch.cos(p[..., None] * r) * Cr, dim=-1)

    def dA_dt(self, h) -> torch.Tensor:
        """TDVP tangent vector of this state under the two-site Hamiltonian
        h (the xmps iMPS.dA_dt analogue; ``tdvp.dA_dt``)."""
        from .tdvp import dA_dt

        return dA_dt(self.blocked, h)

    def overlap(self, other: "iMPS") -> torch.Tensor:
        """|<psi_A|psi_B>|^2 per site = |dominant eigenvalue of the mixed
        transfer operator|^2, both states canonicalized (xmps overlap, as
        used for Loschmidt echoes, scripts/loschmidt.py:370)."""
        AL, _, _ = left_orthogonalise(self.blocked)
        BL, _, _ = left_orthogonalise(other.blocked)
        lam, _ = tr.right_fixed_point(AL, BL)
        return lam.abs() ** 2


class Map:
    """Mixed transfer operator E^A_B (xmps Map analogue)."""

    def __init__(self, A: torch.Tensor, B: torch.Tensor):
        self.A = torch.as_tensor(A)
        self.B = torch.as_tensor(B)

    def asmatrix(self) -> torch.Tensor:
        return tr.transfer_dense(self.A, self.B)

    def right_fixed_point(self, dense: bool = True):
        return tr.right_fixed_point(self.A, self.B, dense=dense)

    def left_fixed_point(self, dense: bool = True):
        """(x, l) with sum_s A[s]^dag l B[s] = conj(x) l, x the dominant
        eigenvalue shared with the right fixed point.  Circuit readout
        identity: 2 psi[0] = Tr(g l^T)."""
        lam, l = tr.left_fixed_point(self.A, self.B, dense=dense)
        return lam.conj(), l

    @staticmethod
    def _residual(x: torch.Tensor, Ex: torch.Tensor, lam) -> torch.Tensor:
        if lam is None:
            lam = torch.vdot(x.reshape(-1), Ex.reshape(-1)) / torch.vdot(x.reshape(-1), x.reshape(-1))
        return torch.linalg.matrix_norm(Ex - lam * x)

    def is_right_eigenvector(self, r: torch.Tensor, lam=None) -> torch.Tensor:
        """|E r - lam r|_F (lam the Rayleigh quotient if not given)."""
        return self._residual(r, tr.right_matvec(self.A, self.B, r), lam)

    def is_left_eigenvector(self, l: torch.Tensor, lam=None) -> torch.Tensor:
        """|l E - lam l|_F (lam the Rayleigh quotient if not given)."""
        return self._residual(l, tr.left_matvec(self.A, self.B, l), lam)


class TransferMatrix(Map):
    """Transfer operator of a single state (xmps TransferMatrix analogue)."""

    def __init__(self, A: torch.Tensor):
        super().__init__(A, A)

    def eigs(self):
        """(eta, l, r): the dominant eigenvalue with the left and right
        fixed points, hermitian with unit trace (qmps/tools.py:176-182)."""
        eta, r = tr.right_fixed_point(self.A, self.A)
        _, l = tr.left_fixed_point(self.A, self.A)
        return eta, _unit_trace_herm(l), _unit_trace_herm(r)
