"""Fixed-shape Krylov solvers (counterpart of ``qmps_tpu.core.krylov``):
restarted Arnoldi for the dominant eigenpair and restarted GMRES.

Consumers: the matvec fixed points of ``mps/transfer.py`` (large D,
where the dense D^2 x D^2 transfer matrix is too big and plain power
iteration stalls on near-degenerate spectra), their bordered implicit
adjoints, and the geometric-sum solve of the energy-variance certificate
(``mps/tdvp.py``).

Every function takes an optional leading batch: ``v0`` or ``b`` of shape
(..., n) and a ``matvec`` that maps (..., n) to (..., n), so one call
serves every point of a sweep (the JAX package ``vmap``s the unbatched
form).  Iteration counts are fixed: k Arnoldi steps, ``restarts`` cycles,
with no test for convergence.  The basis is built from a list of rows and
``torch.stack``ed (no in-place row writes), so autograd can run through
every function here.
"""
from __future__ import annotations

from typing import Callable

import torch

from .linalg import dominant_eig_dense


def _norm(v: torch.Tensor) -> torch.Tensor:
    return torch.linalg.vector_norm(v, dim=-1, keepdim=True)


def _combine(y: torch.Tensor, Q: torch.Tensor) -> torch.Tensor:
    """sum_i y[..., i] Q[..., i, :] (JAX's ``Q.T @ y``)."""
    return (y[..., None, :] @ Q)[..., 0, :]


def arnoldi(matvec: Callable, v0: torch.Tensor, k: int):
    """k-step Arnoldi factorization A Q_k = Q_{k+1} H (rows of Q are the
    basis vectors).

    Returns (Q, H) of shapes (..., k+1, n) and (..., k+1, k): classical
    Gram-Schmidt with one reorthogonalization pass.  The breakdown floor
    is the type's ``tiny``, element by element: after an invariant
    subspace is found the next row is garbage (or zero) but its H entry is
    ~0, so Ritz values and GMRES solutions are unaffected.
    """
    tiny = torch.finfo(v0.real.dtype).tiny
    rows = [v0 / _norm(v0).clamp(min=tiny)]
    cols = []
    for j in range(k):
        w = matvec(rows[j])
        Q = torch.stack(rows, -2)  # (..., j+1, n): the filled rows only
        h = (Q.conj() @ w[..., None])[..., 0]
        w = w - _combine(h, Q)
        h2 = (Q.conj() @ w[..., None])[..., 0]
        w = w - _combine(h2, Q)
        beta = _norm(w)
        rows.append(w / beta.clamp(min=tiny))
        pad = h.new_zeros(h.shape[:-1] + (k - 1 - j,))
        cols.append(torch.cat([h + h2, beta.to(h.dtype), pad], -1))
    return torch.stack(rows, -2), torch.stack(cols, -1)


def dominant_eigpair_arnoldi(matvec: Callable, v0: torch.Tensor, k: int = 32, restarts: int = 3):
    """Dominant (largest |lam|) eigenpair by restarted Arnoldi.

    Each cycle: k-step Arnoldi, the dominant Ritz pair of the (k, k)
    Hessenberg matrix by 50 repeated squarings (``core.linalg.
    dominant_eig_dense``), restart from the Ritz vector.  The returned lam
    is the Rayleigh quotient on the final vector.  Consumers wrap this in
    an implicit adjoint (``transfer._RightEigpairMatvec``).

    Returns (lam (...,), v (..., n)) with |v| = 1 (phase arbitrary).
    """
    v = v0 / _norm(v0)
    for _ in range(restarts):
        Q, H = arnoldi(matvec, v, k)
        _, y = dominant_eig_dense(H[..., :k, :k], n_squarings=50)
        v = _combine(y, Q[..., :k, :])
        v = v / _norm(v)
    lam = (v.conj() * matvec(v)).sum(-1)
    return lam, v


def _hessenberg_lstsq(H: torch.Tensor, beta: torch.Tensor) -> torch.Tensor:
    """y minimizing |beta e1 - H y| for (..., k+1, k) H, by QR of H and a
    triangular solve: y = R^-1 Q^dag (beta e1) = R^-1 beta conj(Q[0, :]).

    H loses rank when Arnoldi breaks down (its later columns are zero, or
    all of it when the residual is exactly zero).  A diagonal entry of R
    at or below (k+1) eps max|diag R| marks a dropped column: its row of R
    becomes the unit row and its right-hand side zero, so that y entry is
    0, the least-squares solution of least norm that the reference's SVD
    ``lstsq`` (rcond (k+1) eps) returns for zero columns.  (On CUDA
    ``torch.linalg.lstsq`` has only the full-rank ``gels`` solver.)
    """
    k = H.shape[-1]
    Q, R = torch.linalg.qr(H)
    d = R.diagonal(dim1=-2, dim2=-1).abs()
    tol = (k + 1) * torch.finfo(d.dtype).eps * d.amax(-1, keepdim=True)
    drop = d <= tol
    eye = torch.eye(k, dtype=R.dtype, device=R.device)
    R = torch.where(drop[..., :, None], eye, R)
    rhs = torch.where(drop, 0, beta * Q[..., 0, :].conj())
    return torch.linalg.solve_triangular(R, rhs[..., None], upper=True)[..., 0]


def gmres_solve(matvec: Callable, b: torch.Tensor, x0: torch.Tensor | None = None, k: int = 40,
                restarts: int = 4):
    """Restarted GMRES(k) with fixed shapes.

    Per restart: Arnoldi on the residual, then the (k+1, k) least-squares
    problem min |beta e1 - H y| (``_hessenberg_lstsq``: QR and a
    triangular solve).  Returns x after at most ``restarts`` cycles of k
    matvecs and the final residual norm |b - A x| (...,).

    The cycles stop early once every element is done: the last cycle cut
    its residual by less than 10% (it has reached the floor its type's
    rounding sets), or the residual is below eps |b|.  A further cycle
    would only repeat that rounding (the JAX package runs all
    ``restarts`` because its loop has a fixed length), so the check costs
    one host read a cycle and saves, in the VUMPS environments, 5 or 6 of
    8 cycles of 48 matvecs.  An absolute floor of 64 eps |b| instead
    stopped the D = 32 float32 environments a cycle early, and VUMPS
    stalled at gradient 1e-3 on an H100.
    """
    x = torch.zeros_like(b) if x0 is None else x0
    floor = torch.finfo(b.real.dtype).eps * _norm(b)
    prev = None
    for _ in range(restarts):
        r = b - matvec(x)
        beta = _norm(r)
        if prev is not None and bool(((beta <= floor) | (beta > 0.9 * prev)).all()):
            return x, beta[..., 0]
        Q, H = arnoldi(matvec, r, k)
        x = x + _combine(_hessenberg_lstsq(H, beta.to(H.dtype)), Q[..., :k, :])
        prev = beta
    return x, _norm(b - matvec(x))[..., 0]
