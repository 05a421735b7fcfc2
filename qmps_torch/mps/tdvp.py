"""Classical uMPS machinery of ``qmps_tpu.mps.tdvp``, in part: the
energy-variance certificate and what it needs (``_two_site``, ``_h4``,
``_solve_left_env``).  VUMPS, the Hamiltonian environments and the
classical TDVP wait (ROADMAP.md, "VUMPS").

Conventions: two-site Hamiltonian h with h[(u v), (s t)] = <u v| h |s t>;
AL left-canonical (d, D, D), r its right fixed point (unit trace).
Every function is batched over leading dimensions of AL, r and h.
"""
from __future__ import annotations

import math

import torch

from ..core.krylov import gmres_solve
from ..core.linalg import _trace


def _eye(n: int, like: torch.Tensor) -> torch.Tensor:
    return torch.eye(n, dtype=like.dtype, device=like.device)


def _two_site(X: torch.Tensor) -> torch.Tensor:
    """Blocked 2-site tensor AL2[s, t] = AL_s AL_t, shape (..., d, d, D, D)."""
    return torch.einsum("...sij,...tjk->...stik", X, X)


def _h4(h: torch.Tensor) -> torch.Tensor:
    """h[(uv),(st)] -> h4[u, v, s, t]; the physical dimension is read off
    h's shape (d = 2 spin chains, d = 4 blocked two-site cells)."""
    d = math.isqrt(h.shape[-1])
    return h.reshape(h.shape[:-2] + (d, d, d, d))


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
        ALc = AL.conj().resolve_conj()

        def mv(v):
            x = v.reshape(batch + (D, D))
            ELx = torch.einsum("...sia,...sjb,...ij->...ab", ALc, AL, x)
            return (x - ELx + _trace(x @ r)[..., None, None] * eye).reshape(v.shape)

        x, _ = gmres_solve(mv, rhs.reshape(batch + (D * D,)), k=k, restarts=restarts)
        return x.reshape(rhs.shape)
    EL = torch.einsum("...sia,...sjb->...abij", AL.conj(), AL).reshape(AL.shape[:-3] + (D * D, D * D))
    corr = _eye(D, AL).reshape(-1, 1) * r.mT.reshape(r.shape[:-2] + (1, D * D))
    M = _eye(D * D, AL) - EL + corr
    return torch.linalg.solve(M, rhs.reshape(batch + (D * D,))).reshape(rhs.shape)


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
    ht = h - e.to(h.dtype)[..., None, None] * _eye(d * d, h)
    ht4 = _h4(ht)

    # d = 0: <h~^2> on one bond
    t0 = torch.einsum("...uvia,...stib,...ba,...uvst->...", AL2c, AL2, r, _h4(ht @ ht)).real

    # d = 1: overlapping windows on three sites, O3 = (h~ x I)(I x h~)
    AL3 = torch.einsum("...uvik,...wkj->...uvwij", AL2, AL)
    O3 = torch.einsum("...uvsb,...bwtq->...uvwstq", ht4, ht4)
    t1 = torch.einsum("...uvwia,...stqib,...ba,...uvwstq->...", AL3.conj(), AL3, r, O3).real

    # d >= 2: geometric sum of the shifted left environment, then one
    # shifted window capped with r
    hLs = hL - e.to(hL.dtype)[..., None, None] * _eye(hL.shape[-1], hL)
    HL = _solve_left_env(AL, r, hLs, solver=env_solver, k=k, restarts=restarts)
    tail = torch.einsum("...uvia,...stjb,...ij,...ba,...uvst->...", AL2c, AL2, HL, r, ht4).real
    return t0 + 2.0 * t1 + 2.0 * tail
