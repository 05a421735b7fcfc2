"""Transfer-operator fixed points (counterpart of ``qmps_tpu.mps.transfer``),
batched over any leading dimensions.

The right and left matvecs, the dense transfer matrix, the power
iteration in operator form (``dominant_eig_power``), the eigenvalue
with its rank-1 implicit adjoint (``dominant_eigval_dense``), the
eigenpair in a holomorphic c^T v = 1 gauge with its bordered-solve
adjoint (``dominant_eigpair_cgauge``), ``right_fixed_point`` and
``left_fixed_point`` in dense and matvec form (restarted Arnoldi forward,
bordered-GMRES adjoint: ``_RightEigpairMatvec``), and the recycled fixed
points of the large-D optimizers: ``right_eigpair_warm`` (power iteration
from the previous step's environment, implicit adjoint by LU or GMRES)
and ``right_eigpair_warm_unroll`` (plain autograd through the iterations).

The adjoints are ``torch.autograd.Function``s.  For a holomorphic map the
JAX custom_vjp's cotangent Ebar pairs as dlam = sum Ebar dE; PyTorch's
backward takes and returns conjugate cotangents, so each backward here is
conj(JAX's backward at the conjugated incoming cotangent).
"""
from __future__ import annotations

import torch
from torch.autograd.function import once_differentiable

from ..core.krylov import dominant_eigpair_arnoldi, gmres_solve
from ..core.linalg import _chirp, dominant_eig_dense, rotate_to_hermitian


def right_matvec(A: torch.Tensor, B: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """(E r) = sum_s A[s] r B[s]^dag, the right action of the mixed transfer
    operator E^A_B (xmps Map convention)."""
    return torch.einsum("...sij,...jk,...slk->...il", A, r, B.conj())


def left_matvec(A: torch.Tensor, B: torch.Tensor, l: torch.Tensor) -> torch.Tensor:
    """(l E) = sum_s A[s]^dag l B[s], the left action."""
    return torch.einsum("...sji,...jk,...skl->...il", A.conj(), l, B)


def transfer_dense(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Dense (..., D_A D_B, D_A D_B) matrices E with E vec(r) = vec(sum A r B^dag)."""
    E = torch.einsum("...sik,...sjl->...ijkl", A, B.conj())
    n = A.shape[-2] * B.shape[-2]
    return E.reshape(E.shape[:-4] + (n, A.shape[-1] * B.shape[-1]))


def dominant_eig_power(matvec, v0: torch.Tensor, iters: int = 200):
    """Dominant eigenpair by power iteration in operator form: (lam, v)
    with |v| = 1 and lam the Rayleigh quotient <v, matvec(v)>, which
    converges where a complex dominant eigenvalue keeps rotating the
    iterate's phase.  One tensor of any shape is one vector."""
    v = v0 / torch.linalg.vector_norm(v0)
    for _ in range(iters):
        w = matvec(v)
        v = w / torch.linalg.vector_norm(w)
    return torch.vdot(v.flatten(), matvec(v).flatten()), v


class _DominantEigval(torch.autograd.Function):
    @staticmethod
    def forward(ctx, E):
        if not ctx.needs_input_grad[0]:
            return dominant_eig_dense(E)[0]
        lam, v, w = dominant_eig_dense(E, left=True)  # E^dag w = conj(lam) w
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


def _krylov_dims(n: int, iters: int) -> tuple[int, int]:
    """(k, restarts) for an Arnoldi budget of ~iters matvecs."""
    k = min(n, 48)
    return k, max(2, iters // max(k, 1))


def _flat(matvec, A, B):
    """``matvec`` on flat (..., D_A D_B) vectors."""
    D1, D2 = A.shape[-2], B.shape[-2]
    return lambda x: matvec(A, B, x.reshape(x.shape[:-1] + (D1, D2))).reshape(x.shape)


def _eye_start(A, B) -> torch.Tensor:
    """vec of the (D_A, D_B) corner of the identity, one per batch element:
    the Arnoldi start (it has weight on the fixed point)."""
    D1, D2 = A.shape[-2], B.shape[-2]
    v0 = torch.eye(max(D1, D2), dtype=A.dtype, device=A.device)[:D1, :D2].reshape(-1)
    return v0.expand(A.shape[:-3] + (D1 * D2,))


def _bordered_gmres(A, B, lam, v, c, rhs, k: int, restarts: int) -> torch.Tensor:
    """xi of the bordered system [[(E - lam I)^T, c], [-v^T, 0]] [xi; mu] =
    rhs in matvec form (E^T x = conj(E^dag conj(x)), E^dag the left
    action), by restarted GMRES: E is never built."""
    n = v.shape[-1]
    ETmv = _flat(left_matvec, A, B)

    def op(z):
        xi, mu = z[..., :n], z[..., n:]
        top = ETmv(xi.conj()).conj() - lam[..., None] * xi + mu * c
        return torch.cat([top, -(v * xi).sum(-1, keepdim=True)], -1)

    return gmres_solve(op, rhs, k=k, restarts=restarts)[0][..., :n]


def _pullback(xi, A, B, r):
    """(Abar, Bbar) of JAX's convention from -xi^T (dE v), dE v = vec(dA r
    B^dag + A r dB^dag), xi and r as (..., D_A, D_B) matrices."""
    Abar = -torch.einsum("...il,...jk,...slk->...sij", xi, r, B.conj())
    Bbar = -torch.einsum("...il,...sij,...jk->...slk", xi, A, r).conj()
    return Abar, Bbar


class _RightEigpairMatvec(torch.autograd.Function):
    """(lam, vec(r)) of the mixed transfer map in matvec form, c-gauged
    like the dense pair: restarted Arnoldi forward, implicit adjoint by a
    bordered GMRES solve (the backward never differentiates the iteration
    and never builds E)."""

    @staticmethod
    def forward(ctx, A, B, iters):
        n = A.shape[-2] * B.shape[-2]
        k, restarts = _krylov_dims(n, iters)
        lam, v = dominant_eigpair_arnoldi(_flat(right_matvec, A, B), _eye_start(A, B), k, restarts)
        v = v / (_chirp(n, A.dtype, A.device) * v).sum(-1, keepdim=True)
        ctx.save_for_backward(A, B, lam, v)
        ctx.iters = iters
        return lam, v

    @staticmethod
    @once_differentiable
    def backward(ctx, g_lam, g_v):
        A, B, lam, v = ctx.saved_tensors
        D1, D2 = A.shape[-2], B.shape[-2]
        n = D1 * D2
        rhs = torch.cat([g_v.conj(), g_lam.conj()[..., None]], -1)
        k, restarts = _krylov_dims(n + 1, max(ctx.iters, 400))
        xi = _bordered_gmres(A, B, lam, v, _chirp(n, A.dtype, A.device), rhs, k, restarts)
        Abar, Bbar = _pullback(xi.reshape(xi.shape[:-1] + (D1, D2)), A, B, v.reshape(v.shape[:-1] + (D1, D2)))
        return Abar.conj(), Bbar.conj(), None


def right_fixed_point(A: torch.Tensor, B: torch.Tensor, dense: bool = True, iters: int = 40):
    """Dominant (lam, r) of r -> sum_s A[s] r B[s]^dag, r as a (..., D, D)
    matrix, phase-normalized to hermitian with unit Frobenius norm and
    nonnegative trace.  ``dense``: repeated squaring of the D^2 x D^2
    matrix; else restarted Arnoldi on the matvec with a budget of
    max(iters, 200) matvecs (large D)."""
    D1, D2 = A.shape[-2], B.shape[-2]
    if dense:
        E = transfer_dense(A, B)
        lam, v = dominant_eigpair_cgauge(E, _chirp(D1 * D2, E.dtype, E.device))
    else:
        lam, v = _RightEigpairMatvec.apply(A, B, max(iters, 200))
    r = rotate_to_hermitian(v.reshape(v.shape[:-1] + (D1, D2)))
    return lam, r / torch.linalg.matrix_norm(r)[..., None, None]


def left_fixed_point(A: torch.Tensor, B: torch.Tensor, dense: bool = True, iters: int = 40):
    """Dominant (lam, l) of l -> sum_s A[s]^dag l B[s], l as a (..., D, D)
    matrix in the gauge of ``right_fixed_point``: the left action of E is
    the right action of the daggered tensors.  The matvec form runs the
    same Arnoldi as the JAX package's (same map, same start) and takes the
    implicit adjoint where JAX differentiates through the iteration."""
    return right_fixed_point(A.mH, B.mH, dense=dense, iters=iters)


# ---------------------------------------------------------------------------
# Recycled fixed points (environment recycling across optimizer steps)
# ---------------------------------------------------------------------------


def _power_forward(A, B, r0, iters: int):
    """Normalized right power iteration from r0 and the Rayleigh quotient:
    the one forward of ``right_eigpair_warm`` (implicit adjoint) and
    ``right_eigpair_warm_unroll`` (plain autograd), so the unroll
    gradient is the exact gradient of what the warm pair evaluates."""
    # E r = [A_0 r | A_1 r | ...] @ [B_0^dag; B_1^dag; ...]: A's rows taken in
    # (i, s) order make the first product's output that row of blocks as a
    # view, so an iteration is two batched products (a view of V's layout
    # when A comes from an isometry, as in optim/riemann)
    d, D1 = A.shape[-3], A.shape[-2]
    Ar = A.transpose(-3, -2).reshape(A.shape[:-3] + (D1 * d, A.shape[-1]))
    Bh = B.conj().transpose(-1, -2).reshape(B.shape[:-3] + (d * B.shape[-1], B.shape[-2]))

    def mv(r):
        x = Ar @ r
        return x.reshape(x.shape[:-2] + (D1, -1)) @ Bh

    r = r0 / torch.linalg.matrix_norm(r0)[..., None, None]
    for _ in range(iters):
        w = mv(r)
        r = w / torch.linalg.matrix_norm(w)[..., None, None]
    return (r.conj() * mv(r)).sum((-2, -1)), r


class _RightEigpairWarm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, A, B, r0, iters, bwd):
        lam, r = _power_forward(A, B, r0, iters)
        ctx.save_for_backward(A, B, lam, r)
        ctx.iters, ctx.bwd, ctx.r0 = iters, bwd, (r0.shape, r0.dtype, r0.device)
        return lam, r

    @staticmethod
    @once_differentiable
    def backward(ctx, g_lam, g_r):
        A, B, lam, r = ctx.saved_tensors
        D1, D2 = A.shape[-2], B.shape[-2]
        n = D1 * D2
        v = r.reshape(r.shape[:-2] + (n,))
        c = v.conj()  # linear gauge functional: c^T v = |v|^2 = 1 at the point
        rhs = torch.cat([g_r.conj().reshape(v.shape), g_lam.conj()[..., None]], -1)
        use_lu = n <= 1024 if ctx.bwd == "auto" else ctx.bwd == "lu"
        if use_lu:
            E = transfer_dense(A, B)
            M = torch.zeros(E.shape[:-2] + (n + 1, n + 1), dtype=E.dtype, device=E.device)
            M[..., :n, :n] = E.mT - lam[..., None, None] * torch.eye(n, dtype=E.dtype, device=E.device)
            M[..., :n, n] = c
            M[..., n, :n] = -v
            xi = torch.linalg.solve(M, rhs)[..., :n]
        else:
            # a budget of ~4x the forward's matvecs: the pair is itself only
            # a recycled one (qmps_tpu/mps/transfer.py:350-361), k = 32
            k = min(n + 1, 32)
            xi = _bordered_gmres(A, B, lam, v, c, rhs, k, max(3, -(-4 * ctx.iters // k)))
        Abar, Bbar = _pullback(xi.reshape(r.shape), A, B, r)
        shape, dtype, device = ctx.r0
        r0bar = torch.zeros(shape, dtype=dtype, device=device) if ctx.needs_input_grad[2] else None
        return Abar.conj(), Bbar.conj(), r0bar, None, None


def right_eigpair_warm(A: torch.Tensor, B: torch.Tensor, r0: torch.Tensor, iters: int = 24,
                       bwd: str = "auto"):
    """Dominant (lam, r) of the right transfer action, warm-started at r0:
    ``iters`` power matvecs (O(d D^3) each) from the previous optimizer
    step's environment instead of a solve from scratch.

    Backward: the implicit c-gauge adjoint at the returned pair, a
    bordered linear solve: LU on the built E for n = D_A D_B <= 1024
    ("auto"; "lu" forces it), restarted GMRES in matvec form above it
    ("gmres" forces it), k = 32 and ceil(4 iters / 32) restarts (at least
    3).  r0 gets a zero cotangent: at convergence the fixed point does not
    depend on the start, so recycling r makes no cross-step backward
    chain.  Returns (lam, r) with r unit-Frobenius, phase as the iteration
    leaves it (positive for A == B and a PSD start)."""
    return _RightEigpairWarm.apply(A, B, r0, iters, bwd)


def right_eigpair_warm_unroll(A: torch.Tensor, B: torch.Tensor, r0: torch.Tensor, iters: int = 24):
    """``right_eigpair_warm`` with plain autograd back through the power
    iterations: batched matmuls only (the batched LU of the implicit
    adjoint is pivot-sequential), the exact gradient of the iters-refined
    energy that the recycled optimizer descends; it equals the implicit
    gradient as the power residual vanishes.  The batched sweeps use it."""
    return _power_forward(A, B, r0, iters)
