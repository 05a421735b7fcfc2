"""Classical uniform-MPS machinery (counterpart of ``qmps_tpu.mps.tdvp``):
the mixed gauge and energy density, the Hamiltonian environments, the
energy-variance certificate, the classical TDVP (the xmps iTDVP /
``dA_dt`` replacement: Euler and RK4 steppers, ``Trajectory``), and VUMPS
(Zauner-Stauber et al., PRB 97, 045145 (2018)): ``vumps_step``,
``vumps_ground_state``, its converged wrapper, the variance certificate
of a returned state, two-site cells and ``split_cell``.

Conventions: two-site Hamiltonian h with h[(u v), (s t)] = <u v| h |s t>;
mixed gauge (AL, AR, C), AC = AL C; r = C C^dag (unit trace) is the right
fixed point of AL's transfer, l = C^dag C the left one of AR's.

The environments, effective Hamiltonians and tangents are batched over
leading dimensions of their tensors; the steppers, ``Trajectory`` and
VUMPS take one state, as the JAX package's do.  No gradient flows through
VUMPS, the steppers or ``Trajectory``: they run under ``torch.no_grad``.
A VUMPS iteration waits for the host only in its SVDs and in each
Lanczos run's small ``eigh``: the Lanczos recurrence masks with
``torch.where`` and never reads a value back.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..config import FAST_CDTYPE, FAST_RDTYPE, default_dtypes, resolve_device
from ..core.krylov import gmres_solve
from ..core.linalg import _trace
from . import transfer as tr


def _eye(n: int, like: torch.Tensor) -> torch.Tensor:
    return torch.eye(n, dtype=like.dtype, device=like.device)


def _solve(M: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Dense solve M x = b without the error check (a singular M gives
    non-finite values, as the JAX package's solve does, and the card
    never waits for the host)."""
    return torch.linalg.solve_ex(M, b)[0]


def _scalar(e: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """A real (...,) scalar as (..., 1, 1) of like's type, to shift by e I."""
    return e.to(like.dtype)[..., None, None]


def mixed_gauge(A: torch.Tensor):
    """(AL, AR, C) of a uMPS tensor: delegates to ``iMPS.mixed``, the one
    mixed-gauge implementation of the package."""
    from .imps import iMPS

    return iMPS([A]).mixed()


def _two_site(X: torch.Tensor) -> torch.Tensor:
    """Blocked 2-site tensor AL2[s, t] = AL_s AL_t, shape (..., d, d, D, D)."""
    return _pair(X, X)


def _pair(X: torch.Tensor, Y: torch.Tensor) -> torch.Tensor:
    """Two-site tensor P[s, t] = X_s Y_t, shape (..., d, d, D, D)."""
    return torch.einsum("...sij,...tjk->...stik", X, Y)


def _h4(h: torch.Tensor) -> torch.Tensor:
    """h[(uv),(st)] -> h4[u, v, s, t]; the physical dimension is read off
    h's shape (d = 2 spin chains, d = 4 blocked two-site cells)."""
    d = math.isqrt(h.shape[-1])
    return h.reshape(h.shape[:-2] + (d, d, d, d))


def _as_h(h, like: torch.Tensor) -> torch.Tensor:
    """A two-site Hamiltonian (tensor, array or ``Hamiltonian``) as a
    tensor of like's device and type."""
    if not isinstance(h, torch.Tensor):
        from ..ham.hamiltonian import as_host_matrix

        h = torch.as_tensor(np.asarray(as_host_matrix(h)))
    return h.to(like.device, like.dtype)


def _h_on(h: torch.Tensor, X2: torch.Tensor) -> torch.Tensor:
    """sum_st h4[u, v, s, t] X2[s, t]: h applied to the physical legs of a
    two-site tensor (..., d, d, D, D)."""
    d = X2.shape[-4]
    out = h @ X2.reshape(X2.shape[:-4] + (d * d, -1))
    return out.reshape(X2.shape)


def _energy_at(AL: torch.Tensor, r: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """<h> per site of left-canonical AL with right fixed point r."""
    AL2 = _two_site(AL)
    return torch.einsum("...uvia,...uvia->...", AL2.conj(), _h_on(h, AL2) @ r[..., None, None, :, :]).real


def energy_density(AL: torch.Tensor, C: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """<h> per site in mixed gauge."""
    return _energy_at(AL, C @ C.mH, h)


def _solve_left_env(AL: torch.Tensor, r: torch.Tensor, rhs: torch.Tensor, solver: str = "dense",
                    k: int = 48, restarts: int = 8) -> torch.Tensor:
    """x solving x - E_L(x) + tr(x r) I = rhs (E_L(x) = sum AL^dag x AL);
    the rank-1 term removes the unit eigenvalue so the system is regular.

    "dense" builds the (D^2, D^2) matrix, O(D^6); "gmres" runs the
    fixed-shape restarted GMRES of ``core.krylov`` on the matvec, O(d D^3)
    a step, batched over every leading dimension."""
    D = AL.shape[-1]
    batch = rhs.shape[:-2]
    if solver == "gmres":
        eye = _eye(D, AL)
        ALh = AL.conj().resolve_conj().reshape(AL.shape[:-3] + (-1, D)).mT  # [a, (s, i)]
        rT = r.mT

        def mv(v):
            x = v.reshape(batch + (D, D))
            ELx = ALh @ (x[..., None, :, :] @ AL).reshape(batch + (-1, D))
            return (x - ELx + (x * rT).sum((-2, -1))[..., None, None] * eye).reshape(v.shape)

        x, _ = gmres_solve(mv, rhs.reshape(batch + (D * D,)), k=k, restarts=restarts)
        return x.reshape(rhs.shape)
    EL = torch.einsum("...sia,...sjb->...abij", AL.conj(), AL).reshape(AL.shape[:-3] + (D * D, D * D))
    corr = _eye(D, AL).reshape(-1, 1) * r.mT.reshape(r.shape[:-2] + (1, D * D))
    M = _eye(D * D, AL) - EL + corr
    return _solve(M, rhs.reshape(batch + (D * D,))).reshape(rhs.shape)


def _solve_right_env(AR: torch.Tensor, l: torch.Tensor, rhs: torch.Tensor, solver: str = "dense",
                     k: int = 48, restarts: int = 8) -> torch.Tensor:
    """x solving x - E_R(x) + tr(l x) I = rhs (E_R(x) = sum AR x AR^dag).

    The rank-1 row is the functional x -> tr(l x) in row-major vec form:
    tr(l x) = sum_ij l[i,j] x[j,i] = l.T.flat . x.flat.  The transpose is
    load-bearing: l.flat encodes tr(l^T x), and for a complex l the
    difference shifted HR by a complex multiple of I.  It cancelled in
    dA_dt's dAC - AL dC, which is why the TDVP trajectories were right,
    but every direct consumer of HR or H_C saw the shift (the JAX
    package's record, tdvp.py:88-96).  See ``_solve_left_env`` for the
    dense and GMRES forms."""
    D = AR.shape[-1]
    batch = rhs.shape[:-2]
    if solver == "gmres":
        eye = _eye(D, AR)
        ARc = AR.conj().resolve_conj()

        def mv(v):
            x = v.reshape(batch + (D, D))
            ERx = torch.einsum("...saj,...sbj->...ab", AR @ x[..., None, :, :], ARc)
            return (x - ERx + _trace(l @ x)[..., None, None] * eye).reshape(v.shape)

        x, _ = gmres_solve(mv, rhs.reshape(batch + (D * D,)), k=k, restarts=restarts)
        return x.reshape(rhs.shape)
    ER = torch.einsum("...sai,...sbj->...abij", AR, AR.conj()).reshape(AR.shape[:-3] + (D * D, D * D))
    corr = _eye(D, AR).reshape(-1, 1) * l.mT.reshape(l.shape[:-2] + (1, D * D))
    M = _eye(D * D, AR) - ER + corr
    return _solve(M, rhs.reshape(batch + (D * D,))).reshape(rhs.shape)


def hamiltonian_environments(AL: torch.Tensor, AR: torch.Tensor, C: torch.Tensor, h: torch.Tensor,
                             env_solver: str = "dense"):
    """(HL, HR, e): the summed Hamiltonian environments left and right of
    a site, extensive part (energy density e) subtracted.  ``env_solver``:
    "dense" (O(D^6), D <= ~32) or "gmres" (O(d D^3) a step: the D = 32-64
    VUMPS path)."""
    r = C @ C.mH
    l = C.mH @ C
    AL2 = _two_site(AL)
    AR2 = _two_site(AR)
    D = AL.shape[-1]

    # h on the two sites immediately left (boundary I)
    hL = torch.einsum("...uvia,...uvib->...ab", AL2.conj(), _h_on(h, AL2))
    e = _trace(hL @ r).real
    hL = hL - _scalar(e, hL) * _eye(D, hL)

    # h on the two sites immediately right (boundary I)
    hR = torch.einsum("...uvak,...uvbk->...ab", _h_on(h, AR2), AR2.conj())
    hR = hR - _trace(l @ hR)[..., None, None] * _eye(D, hR)
    if env_solver == "gmres":
        # one GMRES for both: transposed, the right equation is the left
        # one of the tensors AR_s^T with r = l^T (tr(l x) = tr(x^T l^T)),
        # so the two solves run as a batch of two
        X = _solve_left_env(torch.stack([AL, AR.mT], -4), torch.stack([r, l.mT], -3),
                            torch.stack([hL, hR.mT], -3), solver="gmres")
        return X[..., 0, :, :], X[..., 1, :, :].mT, e
    HL = _solve_left_env(AL, r, hL, solver=env_solver)
    HR = _solve_right_env(AR, l, hR, solver=env_solver)
    return HL, HR, e


def energy_variance_density(AL: torch.Tensor, r: torch.Tensor, h: torch.Tensor, env_solver: str = "dense",
                            k: int = 48, restarts: int = 8) -> torch.Tensor:
    """Per-site energy variance sigma^2 = lim_N (<H^2> - <H>^2) / N, the
    oracle-free convergence certificate: zero iff the uMPS is an exact
    eigenstate of H = sum_n h_{n,n+1}, and |E - E_0| <= sigma^2 / gap for
    an optimized state.

    With h~ = h - e the shifted bond term,
        sigma^2 = <h~_0 h~_0> + 2 Re <h~_0 h~_1> + 2 Re sum_{d>=2} <h~_0 h~_d>;
    the d >= 2 tail is the regularized geometric sum of the shifted left
    environment (``_solve_left_env``, dense or GMRES), closed by one
    shifted window capped with r.

    AL left-canonical (..., d, D, D), r its right fixed point (unit trace),
    h (..., d^2, d^2).  Returns real (...,) variances, >= 0 up to the
    solver's tolerance.
    """
    d = AL.shape[-3]
    h4 = _h4(h)
    AL2 = _two_site(AL)
    AL2c = AL2.conj()

    hL = torch.einsum("...uvia,...stib,...uvst->...ab", AL2c, AL2, h4)
    e = _trace(hL @ r).real
    ht = h - _scalar(e, h) * _eye(d * d, h)
    ht4 = _h4(ht)

    # d = 0: <h~^2> on one bond
    t0 = torch.einsum("...uvia,...stib,...ba,...uvst->...", AL2c, AL2, r, _h4(ht @ ht)).real

    # d = 1: overlapping windows on three sites, O3 = (h~ x I)(I x h~)
    AL3 = torch.einsum("...uvik,...wkj->...uvwij", AL2, AL)
    O3 = torch.einsum("...uvsb,...bwtq->...uvwstq", ht4, ht4)
    t1 = torch.einsum("...uvwia,...stqib,...ba,...uvwstq->...", AL3.conj(), AL3, r, O3).real

    # d >= 2: geometric sum of the shifted left environment, then one
    # shifted window capped with r
    hLs = hL - _scalar(e, hL) * _eye(hL.shape[-1], hL)
    HL = _solve_left_env(AL, r, hLs, solver=env_solver, k=k, restarts=restarts)
    tail = torch.einsum("...uvia,...stjb,...ij,...ba,...uvst->...", AL2c, AL2, HL, r, ht4).real
    return t0 + 2.0 * t1 + 2.0 * tail


def effective_H_AC(AC, AL, AR, HL, HR, h) -> torch.Tensor:
    """One-site effective Hamiltonian H_AC applied to AC (pairwise
    contractions in a fixed order, O(d^4 D^3))."""
    # h on (site-1, site): sum h4[u,v,t,s] AL_u^dag AL_t AC_s -> component v
    a = torch.einsum("...uia,...uvik->...vak", AL.conj(), _h_on(h, _pair(AL, AC)))
    # h on (site, site+1): sum h4[u,v,s,t] AC_s AR_t AR_v^dag -> component u
    b = torch.einsum("...uvik,...vlk->...uil", _h_on(h, _pair(AC, AR)), AR.conj())
    return a + b + HL[..., None, :, :] @ AC + AC @ HR[..., None, :, :]


def effective_H_C(C, AL, AR, HL, HR, h) -> torch.Tensor:
    """Zero-site effective Hamiltonian H_C applied to the center matrix."""
    Y = _h_on(h, _pair(AL @ C[..., None, :, :], AR))
    W = torch.einsum("...uvil,...vml->...uim", Y, AR.conj())
    return torch.einsum("...uia,...uim->...am", AL.conj(), W) + HL @ C + C @ HR


def dAC_dC_dt(AL, AR, C, h, env_solver: str = "dense"):
    """(-i H_AC(AC), -i H_C(C), energy density).

    The energy density is subtracted from h everywhere (local terms and
    the geometric sums), so the flow is phase-free: on a variational
    ground state dAC = AL dC exactly (zero physical tangent)."""
    AC = AL @ C[..., None, :, :]
    HL, HR, e = hamiltonian_environments(AL, AR, C, h, env_solver=env_solver)
    h_shift = h - _scalar(e, h) * _eye(h.shape[-1], h)
    dAC = -1j * effective_H_AC(AC, AL, AR, HL, HR, h_shift)
    dC = -1j * effective_H_C(C, AL, AR, HL, HR, h_shift)
    return dAC, dC, e


def dA_dt(A: torch.Tensor, h) -> torch.Tensor:
    """Tangent vector of a left-canonical tensor A (the xmps iMPS.dA_dt
    analogue): B = (dAC - AL dC) C^{-1}, in A's left gauge."""
    AL, AR, C = mixed_gauge(A)
    dAC, dC, _ = dAC_dC_dt(AL, AR, C, _as_h(h, AL))
    return (dAC - AL @ dC) @ _pinv(C)


def _polar(M: torch.Tensor) -> torch.Tensor:
    """The isometric polar factor U Vh of M's thin SVD: orthonormal columns
    for a tall M, orthonormal rows for a wide one."""
    u, _, vh = torch.linalg.svd(M, full_matrices=False)
    return u @ vh


def _pinv(C: torch.Tensor, rcond: float = 1e-6) -> torch.Tensor:
    """SVD pseudo-inverse with a cutoff relative to the largest singular
    value: the standard TDVP guard against near-singular center matrices
    (a state whose effective rank is below D makes inv(C) arbitrarily
    ill-conditioned and blows up the flow)."""
    u, s, vh = torch.linalg.svd(C)
    cut = rcond * s[..., :1]
    sinv = torch.where(s > cut, 1.0 / torch.maximum(s, cut), torch.zeros_like(s))
    return vh.mH @ (sinv[..., :, None].to(C.dtype) * u.mH)


def _refresh_C(ALn: torch.Tensor) -> torch.Tensor:
    """C from the right fixed point of a (new) left-isometric AL: keeps the
    gauge exact after a retraction (shared by both steppers).  The jitter
    is 32 eps of the type; the factorization is not error-checked, like
    the JAX package's."""
    _, r = tr.right_fixed_point(ALn, ALn)
    r = (r + r.mH) / 2
    r = r / _trace(r)[..., None, None]
    eps = 32 * torch.finfo(r.real.dtype).eps
    return torch.linalg.cholesky_ex(r + eps * _eye(r.shape[-1], r))[0]


def _extract_AL(AC: torch.Tensor, C2: torch.Tensor) -> torch.Tensor:
    """AL <- polar(AC) polar(C)^dag (gauge-preserving retraction)."""
    d, D, _ = AC.shape
    UAC = _polar(AC.transpose(0, 1).reshape(D * d, D))
    UC = _polar(C2)
    return (UAC @ UC.mH).reshape(D, d, D).transpose(0, 1)


def _euler_step(AL, C, dt: float, tangent):
    """Explicit-Euler TDVP step; ``tangent(AL, C) -> (dAC, dC, e)``
    supplies the flow (dense two-site h or MPO: ``mps.mpo``), the
    gauge-preserving polar retraction is shared."""
    dAC, dC, e = tangent(AL, C)
    ALn = _extract_AL(AL @ C + dt * dAC, C + dt * dC)
    return ALn, _refresh_C(ALn), e


def _tangent_dense(h, env_solver: str = "dense"):
    """tangent(AL, C) of a dense two-site h: AR from the center gauge,
    then the phase-free mixed-gauge flow."""
    def tangent(AL, C):
        AR = _pinv(C) @ AL @ C
        return dAC_dC_dt(AL, AR, C, h, env_solver=env_solver)

    return tangent


def tdvp_step(AL, C, h, dt: float):
    """One explicit-Euler TDVP step in mixed gauge with the polar
    re-extraction AL <- polar(AC') polar(C')^dag: gauge-preserving by
    construction."""
    return _euler_step(AL, C, dt, _tangent_dense(h))


def _rk4_step(AL, C, dt: float, tangent):
    """Classical-RK4 TDVP step (``tdvp_step_rk4``); ``tangent`` as in
    ``_euler_step``."""
    AC0 = AL @ C
    k1AC, k1C, e = tangent(AL, C)

    def stage(aAC, aC):
        ACi, Ci = AC0 + aAC, C + aC
        return tangent(_extract_AL(ACi, Ci), Ci)

    k2AC, k2C, _ = stage(0.5 * dt * k1AC, 0.5 * dt * k1C)
    k3AC, k3C, _ = stage(0.5 * dt * k2AC, 0.5 * dt * k2C)
    k4AC, k4C, _ = stage(dt * k3AC, dt * k3C)

    AC = AC0 + (dt / 6.0) * (k1AC + 2 * k2AC + 2 * k3AC + k4AC)
    C2 = C + (dt / 6.0) * (k1C + 2 * k2C + 2 * k3C + k4C)
    ALn = _extract_AL(AC, C2)
    return ALn, _refresh_C(ALn), e


def tdvp_step_rk4(AL, C, h, dt: float):
    """One classical RK4 TDVP step in mixed gauge: the tangent at four
    stage points, each on the manifold (AL re-extracted by the polar
    retraction).  4x the cost of ``tdvp_step``, but stable at time steps
    where explicit Euler freezes at dynamical phase transitions (Euler at
    dt = 2e-3 stalls the g 1.5 -> 0.2 quench at the first one; RK4 at the
    same dt tracks the exact rate through it)."""
    return _rk4_step(AL, C, dt, _tangent_dense(h))


def _is_32bit(x) -> bool:
    """Whether a tensor or array is float32 or complex64."""
    dt = getattr(x, "dtype", None)
    if isinstance(dt, torch.dtype):
        return dt in (FAST_CDTYPE, FAST_RDTYPE)
    return dt is not None and np.dtype(dt) in (np.complex64, np.float32)


def _working_dtype(device, A0, h=None) -> torch.dtype:
    """The working type of an entry point given a start A0 and a
    Hamiltonian h: A0's precision if given, else h's.  A 32-bit tensor or
    array means complex64, a 64-bit tensor complex128, anything else the
    device's default (``config.default_dtypes``)."""
    x = A0 if A0 is not None else h
    if _is_32bit(x):
        return FAST_CDTYPE
    return default_dtypes(device, x if isinstance(x, torch.Tensor) else None)[0]


@dataclasses.dataclass
class Trajectory:
    """The xmps iTDVP.Trajectory analogue: integrate the TDVP flow from A0
    and report Loschmidt echoes (qmps/loschmidts/mps_loschmidts.py:13-27).

    ``h`` is a dense two-site Hamiltonian (tensor, array or
    ``Hamiltonian``) or an ``mps.mpo.MPO``: finite-range and
    exponentially decaying models have no two-site form.  For a two-site
    model the two paths agree array for array.  ``env_solver`` picks the
    geometric-sum solver ("dense" below D ~ 32, "gmres" above).
    ``device``: None runs where a tensor A0 lies, else on the card; the
    precision is A0's (``_working_dtype``).

    Match D to the initial state's entanglement: Schmidt values below the
    ``_pinv`` cutoff (1e-6) make the truncated inverse of C corrupt the
    flow instead of guarding it (the JAX package measured it on the
    NNN-Ising g = 0.5 ground state: D = 4 tracks ED, D = 6 and 8 do not).

    After ``eulerint`` or ``rk4int``: ``ALs`` (n_steps + 1, d, D, D), the
    start first, and ``es`` (n_steps,), the energy density at each step's
    start."""

    A0: object
    h: object
    env_solver: str = "dense"
    device: object = None

    def eulerint(self, T: float, n_steps: int):
        """Integrate with ``n_steps`` explicit-Euler steps to time T."""
        return self._integrate(T, n_steps, _euler_step)

    def rk4int(self, T: float, n_steps: int):
        """Integrate with classical RK4 steps: 4x the cost of ``eulerint``,
        stable where Euler stalls at dynamical phase transitions."""
        return self._integrate(T, n_steps, _rk4_step)

    def _tangent(self, like: torch.Tensor):
        from .mpo import MPO, _tangent_mpo  # deferred: mpo imports tdvp

        if isinstance(self.h, MPO):
            return _tangent_mpo(self.h, env_solver=self.env_solver)
        return _tangent_dense(_as_h(self.h, like), env_solver=self.env_solver)

    @torch.no_grad()
    def _integrate(self, T: float, n_steps: int, stepper):
        device = resolve_device(self.device, self.A0)
        A0 = torch.as_tensor(self.A0).to(device, _working_dtype(device, self.A0))
        dt = T / n_steps
        AL, _, C = mixed_gauge(A0)
        tangent = self._tangent(AL)
        ALs, es = [AL], []
        for _ in range(n_steps):
            AL, C, e = stepper(AL, C, dt, tangent)
            ALs.append(AL)
            es.append(e)
        self.ALs = torch.stack(ALs)
        self.es = torch.stack(es)
        return self

    @torch.no_grad()
    def loschmidts(self) -> torch.Tensor:
        """|<psi_0 | psi_t>|^2 per site along the trajectory: one batched
        fixed-point solve of every step's mixed transfer with the start."""
        lam, _ = tr.right_fixed_point(self.ALs[1:], self.ALs[:1].expand_as(self.ALs[1:]))
        return lam.abs() ** 2


# -- VUMPS: the variational uniform-MPS ground-state solver -------------------
#
# Per iteration: the ground eigenvectors of H_AC and H_C at fixed
# environments, then (AL, AR) re-extracted by polar decompositions.
# Unlike gradient descent on a parametrization, VUMPS converges to the
# D-optimal state (gradient norm -> 1e-8 and below) even at criticality.


def _lanczos_ground(matvec, v0: torch.Tensor, k: int):
    """(theta, v): the approximate smallest eigenpair of a hermitian
    operator by k steps of Lanczos with full reorthogonalization.  A
    fixed-length loop: after a breakdown the remaining steps are masked
    out with ``torch.where``, never by a branch on a value (on the card
    each would wait for the host); the (k, k) tridiagonal problem is
    solved dense with ``eigh``."""
    rtype = v0.real.dtype
    eps = torch.finfo(rtype).eps
    v = v0 / torch.linalg.vector_norm(v0)
    vprev = torch.zeros_like(v)
    b_prev = torch.zeros((), dtype=rtype, device=v.device)
    active = torch.ones((), dtype=torch.bool, device=v.device)
    rows, alpha, beta, mask = [], [], [], []
    for _ in range(k):
        w = matvec(v) - b_prev * vprev
        a = torch.vdot(v, w).real
        w = w - a * v
        # full reorthogonalization: Lanczos loses orthogonality exactly
        # when it converges; one Gram-Schmidt pass against the basis keeps
        # the tridiagonal problem meaningful at k ~ 32
        if rows:
            V = torch.stack(rows)
            w = w - V.mT @ (V.conj() @ w)
        b = torch.linalg.vector_norm(w)
        # dtype-aware breakdown threshold: at convergence the
        # reorthogonalized residual is roundoff at the scale of the
        # recurrence (|a| + b_prev); a fixed 1e-12 admits float32 noise
        # vectors as Krylov directions (the JAX package saw D = 4 VUMPS
        # diverge in float32 from random starts while float64 converged)
        ok = b > 64 * eps * (a.abs() + b_prev + 1.0)
        vn = torch.where(ok, w / torch.where(ok, b, 1.0), 0.0)
        rows.append(torch.where(active, v, 0.0))
        alpha.append(torch.where(active, a, 0.0))
        beta.append(torch.where(active & ok, b, 0.0))
        mask.append(active)
        vprev, v, b_prev, active = v, vn, b, active & ok
    V, alpha, beta, mask = torch.stack(rows), torch.stack(alpha), torch.stack(beta), torch.stack(mask)
    # after a breakdown (the Krylov space is exhausted, common at
    # convergence) the remaining rows are zero-coupled padding: their
    # diagonal goes above the active block's Gershgorin bound, so their
    # eigenpairs sort to the top.  The pad is data-derived, not a 1e30
    # literal: eigh's accuracy is absolute in ||T||, and a huge pad would
    # wash out the small ground eigenvalue (fatally in float32)
    pad = 1.0 + 2.0 * (alpha.abs().max() + beta.max())
    alpha = torch.where(mask, alpha, pad)
    T = torch.diag(alpha) + torch.diag(beta[:-1], 1) + torch.diag(beta[:-1], -1)
    evals, evecs = torch.linalg.eigh(T)
    u = V.mT @ evecs[:, 0].to(V.dtype)  # eigh sorts ascending: column 0 is the ground state
    return evals[0], u / torch.linalg.vector_norm(u)


def _regauge(ACn: torch.Tensor, Cn: torch.Tensor):
    """(AL, AR, C) from the new center-site tensor and center matrix:
    AL' = polar_l(AC') polar_l(C')^dag, AR' = polar_r(C')^dag polar_r(AC')
    (the minimizers of |AC' - AL C'| and |AC' - C AR| over isometries).
    C' carries an arbitrary eigenvector phase; its trace is made real."""
    d, D, _ = ACn.shape
    ALn = _extract_AL(ACn, Cn)
    UAC_r = _polar(ACn.transpose(0, 1).reshape(D, d * D))
    ARn = (_polar(Cn).mH @ UAC_r).reshape(D, d, D).transpose(0, 1)
    ph = torch.exp(-1j * torch.angle(_trace(Cn)))
    return ALn, ARn, Cn * ph.to(Cn.dtype)


def vumps_step(AL, AR, C, h, k: int = 24, env_solver: str = "dense"):
    """One VUMPS iteration: the ground eigenvectors of H_AC and H_C at
    fixed Hamiltonian environments, then the gauge re-extraction
    (``_regauge``).  Returns (AL, AR, C, e, grad_norm); grad_norm =
    |H_AC(AC) - AL H_C(C)| is the tangent-space gradient norm (zero at the
    variational optimum), evaluated at the incoming state.

    AC' and C' come from two Lanczos runs, so AL' carries an arbitrary
    global phase against another implementation's."""
    d, D, _ = AL.shape
    HL, HR, e = hamiltonian_environments(AL, AR, C, h, env_solver=env_solver)
    h_shift = h - _scalar(e, h) * _eye(h.shape[-1], h)
    AC = AL @ C

    gAC = effective_H_AC(AC, AL, AR, HL, HR, h_shift)
    gC = effective_H_C(C, AL, AR, HL, HR, h_shift)
    grad_norm = torch.linalg.vector_norm(gAC - AL @ gC)

    _, ac = _lanczos_ground(
        lambda x: effective_H_AC(x.reshape(d, D, D), AL, AR, HL, HR, h_shift).reshape(-1), AC.reshape(-1), k)
    _, c = _lanczos_ground(
        lambda x: effective_H_C(x.reshape(D, D), AL, AR, HL, HR, h_shift).reshape(-1), C.reshape(-1), k)
    return (*_regauge(ac.reshape(d, D, D), c.reshape(D, D)), e, grad_norm)


def _true_r(AL: torch.Tensor) -> torch.Tensor:
    """AL's right fixed point, hermitian with unit trace: the dense solve
    (40 squarings of the (D^2, D^2) transfer matrix) at full precision."""
    _, r = tr.right_fixed_point(AL, AL)
    r = (r + r.mH) / 2
    return r / _trace(r)


def _auto_solver(env_solver: str, D: int) -> str:
    """"auto": dense geometric sums up to D = 24, GMRES above (the JAX
    package's threshold: the dense solve is O(D^6))."""
    if env_solver == "auto":
        return "dense" if D <= 24 else "gmres"
    return env_solver


def _vumps_start(h, D: int, generator, A0, device):
    """(h as a tensor, the mixed gauge of the start): ``vumps_ground_state``'s
    device, precision and start rules."""
    device = resolve_device(device, A0, h)
    hc = _as_h(h, torch.empty(0, dtype=_working_dtype(device, A0, h), device=device))
    if A0 is None:
        from .imps import random_tensor

        if generator is None:
            generator = torch.Generator().manual_seed(0)
        A0 = random_tensor(generator, math.isqrt(hc.shape[-1]), D, hc.dtype, device)
    return hc, mixed_gauge(torch.as_tensor(A0).to(device, hc.dtype))


def _vumps_iterate(state, step, iters: int):
    """``iters`` iterations of ``step`` ((AL, AR, C) -> (AL, AR, C, e,
    grad_norm)) from state: the new state and the (iters,) in-iteration
    energies and gradient norms, on the device (nothing is read back)."""
    es, gs = [], []
    for _ in range(iters):
        *state, e, g = step(*state)
        es.append(e)
        gs.append(g)
    return tuple(state), torch.stack(es), torch.stack(gs)


@torch.no_grad()
def vumps_ground_state(h, D: int, iters: int = 150, k: int = 24, generator: torch.Generator | None = None,
                       A0=None, env_solver: str = "auto", device=None):
    """D-optimal uMPS ground state of the two-site Hamiltonian h by VUMPS.

    Returns (AL, C, energy, info), info = {"grad_norms": (iters,),
    "energies": (iters,)} tensors.  The energy is evaluated at the
    returned AL's true transfer fixed point (variational even when the run
    stops before convergence; the in-iteration estimator tr(h_L C C^dag)
    read 2e-5 below exact at D = 32 in the JAX package's record), while
    info["energies"] keeps that estimator as a convergence history.

    ``A0`` (d, D, D), tensor or array, is the start; else complex normals
    from ``generator`` (a CPU ``torch.Generator``, seed 0 if None).
    ``device``: None runs where a tensor A0 or h lies, else on the card.
    Working precision (``_working_dtype``): A0's, then h's (a float32 h
    means complex64), else the device's.  ``env_solver`` "auto": dense up
    to D = 24, GMRES above."""
    hc, state = _vumps_start(h, D, generator, A0, device)
    env_solver = _auto_solver(env_solver, D)
    (AL, _, C), es, gs = _vumps_iterate(state, lambda *st: vumps_step(*st, hc, k, env_solver=env_solver), iters)
    return AL, C, float(_energy_at(AL, _true_r(AL), hc)), {"grad_norms": gs, "energies": es}


@torch.no_grad()
def vumps_ground_state_converged(h, D: int, tol: float = 3e-4, chunk_iters: int = 150, max_iters: int = 600,
                                 k: int = 48, generator: torch.Generator | None = None, A0=None,
                                 env_solver: str = "auto", device=None):
    """VUMPS run to a gradient-norm knee instead of a fixed window: chunks
    of ``chunk_iters`` iterations until a chunk ends with gradient norm
    <= tol or ``max_iters`` are spent.  The knob that decides whether the
    knee is reachable is the Lanczos depth ``k``, not the window (the JAX
    package's D = 32 float32 record: k = 24 plateaued near grad 5e-4,
    k = 48 passed 1.3e-4 within 150 iterations).

    The chunks continue one run: (AL, AR, C) carry over.  The JAX package
    re-enters its compiled chunk program from AL through a mixed gauge,
    whose Cholesky of the converged r fails in float32 at D = 64 (it
    raised at the start of the second chunk on an H100: r's smallest
    eigenvalues lie below the factorization's 32 eps jitter).

    Returns (AL, C, e, info): "grad_norms" and "energies" concatenated
    over the chunks run (numpy), "total_iters", and "iters_to_knee", the
    first 1-based iteration with grad <= tol, or -1 if the run ended above
    tol (callers should report it, not assume)."""
    hc, state = _vumps_start(h, D, generator, A0, device)
    env_solver = _auto_solver(env_solver, D)
    grad_hist, e_hist = [], []
    total = 0
    while total < max_iters:
        state, es, gs = _vumps_iterate(state, lambda *st: vumps_step(*st, hc, k, env_solver=env_solver),
                                       chunk_iters)
        grad_hist.append(gs.double().cpu().numpy())
        e_hist.append(es.double().cpu().numpy())
        total += chunk_iters
        if grad_hist[-1][-1] <= tol:
            break
    AL, _, C = state
    gs = np.concatenate(grad_hist)
    below = np.nonzero(gs <= tol)[0]
    info = {"grad_norms": gs, "energies": np.concatenate(e_hist), "total_iters": total,
            "iters_to_knee": int(below[0]) + 1 if below.size else -1}
    return AL, C, float(_energy_at(AL, _true_r(AL), hc)), info


@torch.no_grad()
def variance_certificate(AL, h, env_solver: str = "auto", k: int = 48, restarts: int = 8, device=None) -> float:
    """The oracle-free convergence certificate of a left-canonical state:
    its per-site energy variance under the two-site h, at AL's true right
    fixed point (``energy_variance_density`` with r recomputed).  Zero iff
    AL is an exact eigenstate; |E - E_0| <= sigma^2 / gap.  Runs where a
    tensor AL lies (else on the card), in AL's precision
    (``_working_dtype``)."""
    device = resolve_device(device, AL)
    AL = torch.as_tensor(AL).to(device, _working_dtype(device, AL))
    return float(energy_variance_density(AL, _true_r(AL), _as_h(h, AL),
                                         env_solver=_auto_solver(env_solver, AL.shape[-1]), k=k,
                                         restarts=restarts))


def vumps_ground_state_cell2(h, D: int, iters: int = 150, k: int = 24, generator: torch.Generator | None = None,
                             A0=None, device=None):
    """Two-site unit-cell VUMPS by cell blocking: the chain blocked into
    d^2-dimensional cells (``ham.hamiltonian.block_two_site``), the
    single-site solver on the blocked chain.  This is how the bare
    antiferromagnets converge: their Neel-ordered ground states are only
    2-periodic, which stalls single-site VUMPS at gradient norm O(1).
    Returns (AL_cell (d^2, D, D), C, e, info) with e and info["energies"]
    per original site; ``split_cell`` splits AL_cell.  A0, if given, is a
    blocked (d^2, D, D) tensor."""
    from ..ham.hamiltonian import as_host_matrix, block_two_site

    device = resolve_device(device, A0, h)
    h_host = h.detach().cpu().resolve_conj().numpy() if isinstance(h, torch.Tensor) \
        else np.asarray(as_host_matrix(h))
    hb = block_two_site(h_host)
    # keep the caller's precision: block_two_site returns float64 numpy
    if h_host.dtype in (np.float32, np.complex64):
        hb = hb.astype(np.complex64 if hb.dtype.kind == "c" else np.float32)
    elif isinstance(h, torch.Tensor):
        hb = torch.from_numpy(hb)
    AL, C, e2, info = vumps_ground_state(hb, D, iters=iters, k=k, generator=generator, A0=A0, device=device)
    return AL, C, e2 / 2.0, {**info, "energies": info["energies"] / 2.0}


def split_cell(A_cell: torch.Tensor, D_max: int | None = None):
    """(A1, A2, s): a blocked cell tensor (d^2, D, D) split into two site
    tensors A1 (d, D, m) and A2 (d, m, D) by an SVD of the bond inside
    the cell.

    D_max None: the exact split (m = d D), einsum('sim,tmj->stij', A1, A2)
    reassembles the cell; s are the bare singular values.

    With D_max, the D_max largest Schmidt directions of the internal cut
    are kept: for a left-canonical cell they are the singular values of
    the cell with its right leg weighted by F, F F^dag = r (the cell
    transfer's right fixed point).  The bare tensor's SVD would keep
    gauge-large but physically light directions.  The right leg is
    unweighted after the SVD, so A1 A2 approximates the cell in its
    original gauge; s are then the unit-norm Schmidt values."""
    dd, Dl, Dr = A_cell.shape
    d = math.isqrt(dd)
    A4 = A_cell.reshape(d, d, Dl, Dr)
    if D_max is None:
        M = A4.permute(0, 2, 1, 3).reshape(d * Dl, d * Dr)
        u, s, vh = torch.linalg.svd(M, full_matrices=False)
        m = s.shape[0]
        sq = torch.sqrt(s).to(A_cell.dtype)
        return (u * sq).reshape(d, Dl, m), (sq[:, None] * vh).reshape(m, d, Dr).transpose(0, 1), s

    from .imps import _cholesky_psd

    F = _cholesky_psd(_true_r(A_cell))
    Mw = torch.einsum("stij,jk->sitk", A4, F).reshape(d * Dl, d * Dr)
    u, s, vh = torch.linalg.svd(Mw, full_matrices=False)
    m = min(D_max, s.shape[0])
    sq = torch.sqrt(s[:m]).to(A_cell.dtype)
    A1 = (u[:, :m] * sq).reshape(d, Dl, m)
    A2w = (sq[:, None] * vh[:m, :]).reshape(m, d, Dr)
    return A1, torch.einsum("mtk,kj->tmj", A2w, _pinv(F)), s[:m]
