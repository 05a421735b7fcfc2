"""Transfer-operator fixed points (counterpart of ``qmps_tpu.mps.transfer``),
batched over any leading dimensions.

Ported: the right matvec, the dense transfer matrix, the eigenvalue with
its rank-1 implicit adjoint (``dominant_eigval_dense``), the eigenpair in
a holomorphic c^T v = 1 gauge with its bordered-solve adjoint
(``dominant_eigpair_cgauge``) and the dense ``right_fixed_point``.  The
matvec (Krylov) forms, the left fixed point and the recycled solvers wait
(ROADMAP.md, items 4 and 14).

The adjoints are ``torch.autograd.Function``s.  For a holomorphic map the
JAX custom_vjp's cotangent Ebar pairs as dlam = sum Ebar dE; PyTorch's
backward takes and returns conjugate cotangents, so each backward here is
conj(JAX's backward at the conjugated incoming cotangent).
"""
from __future__ import annotations

import torch
from torch.autograd.function import once_differentiable

from ..core.linalg import _chirp, dominant_eig_dense, rotate_to_hermitian


def right_matvec(A: torch.Tensor, B: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """(E r) = sum_s A[s] r B[s]^dag, the right action of the mixed transfer
    operator E^A_B (xmps Map convention)."""
    return torch.einsum("...sij,...jk,...slk->...il", A, r, B.conj())


def transfer_dense(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Dense (..., D_A D_B, D_A D_B) matrices E with E vec(r) = vec(sum A r B^dag)."""
    E = torch.einsum("...sik,...sjl->...ijkl", A, B.conj())
    n = A.shape[-2] * B.shape[-2]
    return E.reshape(E.shape[:-4] + (n, A.shape[-1] * B.shape[-1]))


class _DominantEigval(torch.autograd.Function):
    @staticmethod
    def forward(ctx, E):
        lam, v = dominant_eig_dense(E)
        if ctx.needs_input_grad[0]:
            _, w = dominant_eig_dense(E.mH)  # E^dag w = conj(lam) w
            ctx.save_for_backward(v, w)
        return lam

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        v, w = ctx.saved_tensors
        # JAX: Ebar = ct conj(w) v^T / (w^dag v); conjugated here
        denom = (w.conj() * v).sum(-1)
        return (g / denom.conj())[..., None, None] * w[..., :, None] * v.conj()[..., None, :]


def dominant_eigval_dense(E: torch.Tensor) -> torch.Tensor:
    """Dominant eigenvalue of (..., n, n) matrices, with the implicit
    adjoint dlam = (w^dag dE v) / (w^dag v), v and w the right and left
    dominant eigenvectors: no backward pass through the squaring."""
    return _DominantEigval.apply(E)


class _EigpairCgauge(torch.autograd.Function):
    @staticmethod
    def forward(ctx, E, c):
        lam, v = dominant_eig_dense(E)
        v = v / (c * v).sum(-1, keepdim=True)
        ctx.save_for_backward(E, lam, v, c)
        return lam, v

    @staticmethod
    @once_differentiable
    def backward(ctx, g_lam, g_v):
        E, lam, v, c = ctx.saved_tensors
        n = E.shape[-1]
        # J = [[E - lam I, -v], [c^T, 0]] from d(Ev - lam v) = 0, d(c^T v) = 0;
        # solve J^T [xi; mu] = [vbar; lambar], then Ebar = -outer(xi, v)
        JT = torch.zeros(E.shape[:-2] + (n + 1, n + 1), dtype=E.dtype, device=E.device)
        JT[..., :n, :n] = (E - lam[..., None, None] * torch.eye(n, dtype=E.dtype, device=E.device)).mT
        JT[..., :n, n] = c
        JT[..., n, :n] = -v
        rhs = torch.cat([g_v.conj(), g_lam.conj()[..., None]], -1)
        xi = torch.linalg.solve(JT, rhs)[..., :n]
        return -(xi.conj()[..., :, None] * v.conj()[..., None, :]), None


def dominant_eigpair_cgauge(E: torch.Tensor, c: torch.Tensor):
    """(lam, v) of (..., n, n) matrices with the holomorphic gauge c^T v = 1,
    whose implicit adjoint is one bordered (n+1) linear solve."""
    return _EigpairCgauge.apply(E, c)


def right_fixed_point(A: torch.Tensor, B: torch.Tensor, dense: bool = True, iters: int = 40):
    """Dominant (lam, r) of r -> sum_s A[s] r B[s]^dag, r as a (..., D, D)
    matrix, phase-normalized to hermitian with unit Frobenius norm and
    nonnegative trace."""
    if not dense:
        raise NotImplementedError(
            "right_fixed_point(dense=False) needs the restarted-Arnoldi matvec solver "
            "of core/krylov (ROADMAP.md, item 14)"
        )
    D1, D2 = A.shape[-2], B.shape[-2]
    E = transfer_dense(A, B)
    lam, v = dominant_eigpair_cgauge(E, _chirp(D1 * D2, E.dtype, E.device))
    r = rotate_to_hermitian(v.reshape(v.shape[:-1] + (D1, D2)))
    return lam, r / torch.linalg.matrix_norm(r)[..., None, None]
