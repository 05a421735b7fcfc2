"""Fully fused batched D = 2 ground-state energy objective (kernels K2, K3).

Math (per element; A left-canonical, so the left fixed point is vec(I)):

  AA[(s1 s2)] = A_s1 A_s2                        (2x2 bond blocks)
  E[(i j), (k l)] = sum_s AA[s, i, k] conj(AA[s, j, l])
  (lam, v) = dominant right eigenpair of E       (lam = 1 analytically),
             v's phase fixed so that tr(v as 2x2) > 0 (_trace_gauge)
  r = herm(v) / tr(herm(v)),  herm(M) = (M + M^dag)/2
  e = Re sum_{t,s} h[t, s] tr_bond( AA_s r AA_t^dag )

The gradient is the hand-derived implicit adjoint of
``qmps_tpu/kernels/energy_fused.py``: the eigenvector cotangent is pushed
through T^T z = P^T vbar (T = lam I - E, P deflating the gauge direction)
by the product-form series (I - X)^-1 = prod_k (I + X^(2^k)), K doublings.

For CUDA tensors (complex64) the forward is one launch of K2 and the
backward one launch of K3 (``csrc/energy_fused.cu``, replacing
``_energy_fwd_kernel`` and ``_energy_bwd_kernel``); for CPU tensors the
plain PyTorch versions below run, at the tensors' own precision.
"""
from __future__ import annotations

import torch
from torch.autograd.function import once_differentiable

from ..utils.profiling import span
from . import _lib
from .pallas_power import _dominant_eig_plain

__all__ = ["energy_objective_fused"]

#: doublings of the adjoint's product-form series (2^24 series terms)
SERIES_K = 24


# ---------------------------------------------------------------------------
# plain PyTorch versions (the kernels' specification on the card, the CPU path)
# ---------------------------------------------------------------------------


def _build(As):
    """(B, 2, 2, 2) -> AA (B, 4, 2, 2), E (B, 4, 4)."""
    AA = torch.einsum("bsik,btkj->bstij", As, As).reshape(-1, 4, 2, 2)
    E = torch.einsum("bsik,bsjl->bijkl", AA, AA.conj()).reshape(-1, 4, 4)
    return AA, E


def _energy_from_parts(AA, r2, hs):
    """e = Re sum h[t,s] AA[s,i,j] r2[j,k] conj(AA[t,i,k])."""
    T = torch.einsum("bsij,bjk,btik->bts", AA, r2, AA.conj())
    return torch.einsum("bts,bts->b", hs.to(T.dtype), T).real


def _r_chain(v):
    """v (B, 4) raw eigenvector -> r1 (hermitized), tau (its trace),
    r2 = r1 / tau (B, 2, 2)."""
    r0 = v.reshape(-1, 2, 2)
    r1 = (r0 + r0.mH) / 2.0
    tau = r1.diagonal(dim1=-2, dim2=-1).sum(-1)
    return r1, tau, r1 / tau[:, None, None]


def _trace_gauge(v):
    """v * conj(tr r0)/|tr r0| with r0 = v as 2x2: the eigenvector's phase
    with the trace of r0 made real and positive (rsqrt floor 1e-30).

    The squaring solve leaves v with the phase of lam^(2^iters), which f32
    rounding makes arbitrary; near a phase of pi/2 herm(v) cancels and
    r = herm(v)/tr herm(v) loses every digit.  Energy and gradient do not
    depend on v's phase (r is invariant under v -> c v for an exact
    eigenvector), so fixing it changes no value, only the conditioning.
    The JAX kernels do not fix it (ROADMAP.md, 'Faults in the port against
    the reference')."""
    tau = v[:, 0] + v[:, 3]
    n2 = tau.real.square() + tau.imag.square()
    return v * (tau.conj() * torch.rsqrt(torch.clamp(n2, min=1e-30)))[:, None]


def _fwd_plain(As, hs, iters):
    """Plain version of K2: (As (B,2,2,2), hs (B,4,4)) -> e, lam, v."""
    AA, E = _build(As)
    lam, v = _dominant_eig_plain(E, iters)
    v = _trace_gauge(v)
    _, _, r2 = _r_chain(v)
    return _energy_from_parts(AA, r2, hs), lam, v


def _series_apply_T(E, lam, v, q):
    """z = (lam I - E^T + lam w v^T/(v^T w))^{-1} P^T q by the product-form
    geometric series; w = vec(I) (left-canonical A).  P^T projects q onto
    the solvable subspace: q <- q - w (v^T q)/(v^T w)."""
    w = torch.zeros(4, dtype=q.dtype, device=q.device)
    w[0] = w[3] = 1.0  # vec(I)
    vw = v @ w
    q = q - ((v * q).sum(-1) / vw)[:, None] * w
    # X = (E^T - lam w v^T / (v^T w)) / lam ;  z = (1/lam) sum_k X^k q
    X = (E.mT - (lam / vw)[:, None, None] * w[None, :, None] * v[:, None, :]) / lam[:, None, None]
    x = q
    for _ in range(SERIES_K):
        x = x + (X @ x[..., None])[..., 0]
        X = X @ X
    return x / lam[:, None]


def _bwd_plain(As, hs, lam, v, ct):
    """Plain version of K3: the adjoint, (Abar, hbar) in the JAX pairing
    convention (de = Re sum Abar dA for a complex leaf)."""
    AA, E = _build(As)
    r1, tau, r2 = _r_chain(v)
    ctc = ct.to(As.dtype)
    h_ = hs.to(As.dtype)
    AAc = AA.conj()

    # ---- direct energy-contraction terms ----
    T = torch.einsum("bsij,bjk,btik->bts", AA, r2, AAc)
    hbar = T * ctc[:, None, None]
    AAbar = torch.einsum("b,bts,bjk,btik->bsij", ctc, h_, r2, AAc)  # ket slot
    AAbar = AAbar + torch.einsum("b,bts,bsij,bjk->btik", ctc, h_, AA, r2).conj()  # bra slot
    r2bar = torch.einsum("b,bts,bsij,btik->bjk", ctc, h_, AA, AAc)

    # ---- r2 = r1 / tau ----
    inner = torch.einsum("bjk,bjk->b", r2bar, r1)
    eye = torch.eye(2, dtype=As.dtype, device=As.device)
    r1bar = r2bar / tau[:, None, None] - (inner / tau**2)[:, None, None] * eye
    # ---- r1 = (r0 + r0^dag)/2 ----
    vbar = ((r1bar + r1bar.mH) / 2.0).reshape(-1, 4)

    # ---- v = dominant eigenvector of E (implicit adjoint, deflated series) ----
    z = _series_apply_T(E, lam, v, vbar)
    Eb = (z[:, :, None] * v[:, None, :]).reshape(-1, 2, 2, 2, 2)  # (B, i, j, k, l)

    # ---- E build: E = sum_s AA[s,i,k] conj(AA[s,j,l]) ----
    AAbar = AAbar + torch.einsum("bijkl,bsjl->bsik", Eb, AAc)
    AAbar = AAbar + torch.einsum("bijkl,bsik->bsjl", Eb, AA).conj()

    return _aa_adjoint(AAbar, As), hbar


def _aa_adjoint(G, A):
    """The adjoint of the two-site block AA[(s1 s2), i, j] = sum_k A[s1,i,k]
    A[s2,k,j]: G (B, 4, 2, 2) pairs with dAA ->
    Abar[s,a,b] = sum_{t,j} G[(s t),a,j] A[t,b,j] + sum_{t,i} G[(t s),i,b] A[t,i,a]."""
    G = G.reshape(-1, 2, 2, 2, 2)  # (B, s1, s2, i, j)
    return torch.einsum("zstaj,ztbj->zsab", G, A) + torch.einsum("ztsib,ztia->zsab", G, A)


# ---------------------------------------------------------------------------
# kernel launches
# ---------------------------------------------------------------------------


@_lib.launcher("energy_fwd")
def _fwd_cuda(As, hs, iters):
    """K2: As (B,2,2,2), hs (B,4,4), both complex64 CUDA -> e, lam, v."""
    B = As.shape[0]
    _lib.require(As, "As", torch.complex64, (B, 2, 2, 2))
    _lib.require(hs, "hs", torch.complex64, (B, 4, 4))
    As, hs = As.contiguous(), hs.contiguous()
    e = torch.empty(B, dtype=torch.float32, device=As.device)
    lam = torch.empty(B, dtype=torch.complex64, device=As.device)
    v = torch.empty(B, 4, dtype=torch.complex64, device=As.device)
    if B:
        _lib.launch("energy_fwd", As.device, As, hs, e, lam, v, B, iters)
    return e, lam, v


@_lib.launcher("energy_bwd")
def _bwd_cuda(As, hs, lam, v, ct):
    """K3: the forward's tensors and ct (B,) -> (Abar, hbar) complex64, JAX
    pairing convention."""
    B = As.shape[0]
    _lib.require(As, "As", torch.complex64, (B, 2, 2, 2))
    _lib.require(hs, "hs", torch.complex64, (B, 4, 4))
    _lib.require(lam, "lam", torch.complex64, (B,))
    _lib.require(v, "v", torch.complex64, (B, 4))
    ct = ct.to(torch.float32).expand(B).contiguous()
    As, hs, lam, v = As.contiguous(), hs.contiguous(), lam.contiguous(), v.contiguous()
    Abar = torch.empty(B, 2, 2, 2, dtype=torch.complex64, device=As.device)
    hbar = torch.empty(B, 4, 4, dtype=torch.complex64, device=As.device)
    if B:
        _lib.launch("energy_bwd", As.device, As, hs, v, lam, ct, Abar, hbar, B, SERIES_K)
    return Abar, hbar


# ---------------------------------------------------------------------------
# public face
# ---------------------------------------------------------------------------


class _EnergyObjective(torch.autograd.Function):
    @staticmethod
    def forward(ctx, As, hs, iters):
        with span("energy.forward"):
            B = As.shape[0]
            hb = hs.expand(B, 4, 4)  # a shared h is broadcast here and summed back
            if As.device.type == "cpu":
                e, lam, v = _fwd_plain(As, hb, iters)
            else:
                hb = hb.to(torch.complex64)
                e, lam, v = _fwd_cuda(As, hb, iters)
            ctx.save_for_backward(As, hb, lam, v)
            ctx.h_shared = hs.dim() == 2
            ctx.h_dtype = hs.dtype
            return e

    @staticmethod
    @once_differentiable
    def backward(ctx, ct):
        with span("energy.backward"):
            As, hb, lam, v = ctx.saved_tensors
            if As.device.type == "cpu":
                Abar, hbar = _bwd_plain(As, hb, lam, v, ct)
            else:
                Abar, hbar = _bwd_cuda(As, hb, lam, v, ct)
            # torch's .grad of a real loss is conj(jax.grad): conjugate the JAX
            # pairing-convention cotangents; a real h takes the real part
            if ctx.h_shared:
                hbar = hbar.sum(0)
            hbar = hbar.conj_physical() if ctx.h_dtype.is_complex else hbar.real
            return Abar.conj_physical(), hbar.to(ctx.h_dtype), None


def energy_objective_fused(As: torch.Tensor, hs: torch.Tensor, iters: int = 48) -> torch.Tensor:
    """Batched D = 2 uMPS energy with exact environments: (B, 2, 2, 2)
    left-canonical tensors and per-point (B, 4, 4) (or shared (4, 4))
    two-site Hamiltonian matrices -> (B,) energies, differentiable in both.

    REQUIRES left-canonical As: the left fixed point is hard-coded to the
    identity.  CPU tensors run the plain PyTorch version at their own
    precision; CUDA tensors (complex64 As) run K2 forward and K3 backward.
    """
    return _EnergyObjective.apply(As, hs, iters)
