"""The Stiefel sweep's environment unroll and its exact adjoint as one
kernel launch each (``csrc/stiefel_unroll.cu``).

Math (per row; d = 2, A_s = V[:, s, :] of the (D, 2, D) view of an
isometry whose rows are (i, s)):

  r_0 = r0 / ||r0||,  W_k = sum_s A_s r_k A_s^dag,  r_{k+1} = W_k / ||W_k||
  lam = <r, sum_s A_s r A_s^dag>,  r = r_iters

``mps/transfer._power_forward`` with B = A, so its plain autograd gradient
is the one computed here.  The adjoint walks k = iters-1 .. 0 from g = rbar
(torch's convention, the conjugate of jax.grad: dL = Re <g, dr>):

  G_W = (g - Re<r_{k+1}, g> r_{k+1}) / ||W_k||     (through the normalisation)
  Abar_s += G_W A_s r_k^dag + G_W^dag A_s r_k        (both places A appears in W)
  g <- sum_s A_s^dag G_W A_s                         (the adjoint map)

from the forward's saved r_k and ||W_k||.  The Rayleigh quotient's own
cotangent (rare: the sweeps read r only) is added around the kernel in
plain PyTorch (``_lam_pullback``).

For CUDA tensors (complex64, D <= 32) the forward is one launch of
``stiefel_unroll_fwd`` and the backward one of ``stiefel_unroll_bwd``; for
CPU tensors the plain versions below run at the tensors' own precision,
with the same saved states.
"""
from __future__ import annotations

import torch
from torch.autograd.function import once_differentiable

from . import _lib


# ---------------------------------------------------------------------------
# plain PyTorch versions (the kernels' specification on the card, the CPU path)
# ---------------------------------------------------------------------------


def _tensors(V):
    """(B, D, 2, D) rows (i, s) -> A (B, 2, D, D), a view."""
    return V.transpose(1, 2)


def _apply(A, r):
    """sum_s A_s r A_s^dag for A (B, 2, D, D), r (B, D, D)."""
    return (A @ r[:, None] @ A.mH).sum(1)


def _apply_adjoint(A, x):
    """sum_s A_s^dag x A_s, the adjoint of ``_apply`` in r."""
    return (A.mH @ x[:, None] @ A).sum(1)


def _pair_cotangent(A, gw, r):
    """A's cotangent (B, 2, D, D) from W = sum_s A_s r A_s^dag, W's
    cotangent gw: G_W A_s r^dag + G_W^dag A_s r."""
    return gw[:, None] @ A @ r.mH[:, None] + gw.mH[:, None] @ A @ r[:, None]


def _fwd_plain(V, r0, iters: int, save: bool):
    """Plain version of the forward kernel: V (B, D, 2, D), r0 (B, D, D) ->
    lam (B,), r (B, D, D) and, if ``save``, rs (B, iters, D, D) (each
    iteration's input r_k) and ns (B, iters) (each ||W_k||, real)."""
    A = _tensors(V)
    r = r0 / torch.linalg.matrix_norm(r0)[:, None, None]
    rs, ns = [], []
    for _ in range(iters):
        w = _apply(A, r)
        n = torch.linalg.matrix_norm(w)
        if save:
            rs.append(r)
            ns.append(n)
        r = w / n[:, None, None]
    lam = (r.conj() * _apply(A, r)).sum((-2, -1))
    if not save:
        return lam, r, None, None
    B, D = V.shape[0], V.shape[1]
    rs = torch.stack(rs, 1) if rs else r.new_zeros(B, 0, D, D)
    ns = torch.stack(ns, 1) if ns else r.real.new_zeros(B, 0)
    return lam, r, rs, ns


def _bwd_plain(V, rs, ns, r, g):
    """Plain version of the backward kernel: the hand-derived reverse
    recurrence from r's cotangent g (B, D, D) -> A's cotangent (B, D, 2, D)
    in V's layout, torch's convention."""
    A = _tensors(V)
    gA = torch.zeros_like(A)
    r_next = r
    for k in reversed(range(rs.shape[1])):
        rk = rs[:, k]
        dot = (r_next.conj() * g).sum((-2, -1)).real
        gw = (g - dot[:, None, None] * r_next) / ns[:, k, None, None]
        gA = gA + _pair_cotangent(A, gw, rk)
        g = _apply_adjoint(A, gw)
        r_next = rk
    return gA.transpose(1, 2)


def _lam_pullback(V, r, g_lam):
    """(r's cotangent, A's cotangent in V's layout) from lam = <r, T(r)>,
    T(r) = sum_s A_s r A_s^dag, and lam's cotangent g_lam (B,):
    conj(g) T(r) + g T^dag(r), and T's own from G_W = g r."""
    A = _tensors(V)
    gl = g_lam[:, None, None]
    g_r = gl.conj() * _apply(A, r) + gl * _apply_adjoint(A, r)
    return g_r, _pair_cotangent(A, gl * r, r).transpose(1, 2)


# ---------------------------------------------------------------------------
# kernel launches
# ---------------------------------------------------------------------------


@_lib.launcher("stiefel_unroll_fwd")
def _fwd_cuda(V, r0, iters: int, save: bool):
    """V (B, D, 2, D), r0 (B, D, D), both complex64 CUDA, D <= 32 (the C
    entry point refuses a larger D) -> lam, r and, if ``save``, rs and ns."""
    B, D = V.shape[0], V.shape[1]
    _lib.require(V, "V", torch.complex64, (B, D, 2, D))
    _lib.require(r0, "r0", torch.complex64, (B, D, D))
    V, r0 = V.resolve_conj().contiguous(), r0.resolve_conj().contiguous()  # a lazy conjugate is materialised
    r = torch.empty(B, D, D, dtype=torch.complex64, device=V.device)
    lam = torch.empty(B, dtype=torch.complex64, device=V.device)
    rs = torch.empty(B, iters, D, D, dtype=torch.complex64, device=V.device) if save else None
    ns = torch.empty(B, iters, dtype=torch.float32, device=V.device) if save else None
    if B:
        _lib.launch("stiefel_unroll_fwd", V.device, V, r0, r, lam, rs, ns, B, D, iters)
    return lam, r, rs, ns


@_lib.launcher("stiefel_unroll_bwd")
def _bwd_cuda(V, rs, ns, r, g):
    """The forward's V, rs, ns, r and r's cotangent g (B, D, D), complex64
    CUDA -> A's cotangent (B, D, 2, D), torch's convention."""
    B, D, iters = V.shape[0], V.shape[1], rs.shape[1]
    _lib.require(V, "V", torch.complex64, (B, D, 2, D))
    _lib.require(rs, "rs", torch.complex64, (B, iters, D, D))
    _lib.require(ns, "ns", torch.float32, (B, iters))
    _lib.require(r, "r", torch.complex64, (B, D, D))
    _lib.require(g, "g", torch.complex64, (B, D, D))
    # autograd hands r's cotangent as a lazy conjugate where the loss read conj(r)
    V, rs, ns, r, g = (x.resolve_conj().contiguous() for x in (V, rs, ns, r, g))
    gV = torch.empty(B, D, 2, D, dtype=torch.complex64, device=V.device)
    if B:
        _lib.launch("stiefel_unroll_bwd", V.device, V, rs, ns, r, g, gV, B, D, iters)
    return gV


# ---------------------------------------------------------------------------
# public face
# ---------------------------------------------------------------------------


class _UnrollEigpair(torch.autograd.Function):
    @staticmethod
    def forward(ctx, A, r0, iters, save):
        ctx.set_materialize_grads(False)
        batch, D = A.shape[:-3], A.shape[-1]
        V = A.transpose(-3, -2).reshape(-1, D, 2, D)  # no copy for A viewed from an isometry
        r0 = r0.to(A.dtype).expand(batch + (D, D)).reshape(-1, D, D)
        run = _fwd_plain if A.device.type == "cpu" else _fwd_cuda
        lam, r, rs, ns = run(V, r0, iters, save)
        if save:
            ctx.save_for_backward(V, rs, ns, r)
        ctx.batch = batch
        return lam.reshape(batch), r.reshape(batch + (D, D))

    @staticmethod
    @once_differentiable
    def backward(ctx, g_lam, g_r):
        V, rs, ns, r = ctx.saved_tensors
        g = torch.zeros_like(r) if g_r is None else g_r.reshape(r.shape)
        gV_lam = None
        if g_lam is not None:
            g_r_lam, gV_lam = _lam_pullback(V, r, g_lam.reshape(-1))
            g = g + g_r_lam
        gV = (_bwd_plain if V.device.type == "cpu" else _bwd_cuda)(V, rs, ns, r, g)
        if gV_lam is not None:
            gV = gV + gV_lam
        D = V.shape[1]
        return gV.reshape(ctx.batch + (D, 2, D)).transpose(-3, -2), None, None, None


def unroll_eigpair(A: torch.Tensor, r0: torch.Tensor, iters: int):
    """(lam, r) of ``iters`` normalised power matvecs r -> sum_s A_s r
    A_s^dag from r0 and the Rayleigh quotient, A (..., 2, D, D), r0
    broadcast to (..., D, D) and given no gradient; differentiable in A by
    the hand-derived reverse recurrence.  CUDA tensors (complex64, D <= 32)
    run one kernel launch forward and one backward; CPU tensors the plain
    versions."""
    # the forward saves its iterates only for a backward (needs_input_grad
    # does not see no_grad)
    return _UnrollEigpair.apply(A, r0, iters, torch.is_grad_enabled() and A.requires_grad)
