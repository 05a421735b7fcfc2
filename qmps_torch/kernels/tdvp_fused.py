"""Fully fused batched D = 2 TDVP objective (kernels K4, K5).

Math (per element; the reference's canonical TDVP cost,
qmps/new_time_evolve.py:193-221):

  AA = A A, BB = B B                     (two-site blocks, (4, 2, 2))
  WAA[s, i, j] = sum_t W[s, t] AA[t, i, j]
  E[(i j), (k l)] = sum_s WAA[s, i, k] conj(BB[s, j, l])
  (lam, v) = dominant right eigenpair of E, w that of E^dag (the left
             eigenvector of E), both read off one squaring chain of E
  objective = -|lam|

The gradient is the rank-1 implicit adjoint of
``qmps_tpu/kernels/tdvp_fused.py::_tdvp_bwd_kernel``: with the pairing
coefficients of the JAX package (df = Re sum T dz for each complex leaf),
K = coef conj(w) v^T, coef = -ct (conj(lam)/|lam|) / (w^dag v), pushed
through the transposed E, W and AA/BB builds to Abar, Bbar and a
per-element Wbar.

For CUDA tensors (complex64) the forward is one launch of K4 and the
backward one launch of K5 (``csrc/tdvp_fused.cu``, replacing
``_tdvp_fused_kernel`` and ``_tdvp_bwd_kernel``); for CPU tensors the
plain PyTorch versions below run, at the tensors' own precision.  W is one
shared (4, 4) gate or a per-element (B, 4, 4) batch.
"""
from __future__ import annotations

import torch
from torch.autograd.function import once_differentiable

from ..mps.imps import merge
from . import _lib
from .energy_fused import _aa_adjoint
from .pallas_power import _extract_eigpair, _left_vector, _squarings

__all__ = ["tdvp_objective_fused"]


# ---------------------------------------------------------------------------
# plain PyTorch versions (the kernels' specification on the card, the CPU path)
# ---------------------------------------------------------------------------


def _build(As, Bs, Wb):
    """As, Bs (B, 2, 2, 2), Wb (B, 4, 4) -> AA, WAA, BB (B, 4, 2, 2), E (B, 4, 4)."""
    AA, BB = merge(As, As), merge(Bs, Bs)
    WAA = torch.einsum("bst,btij->bsij", Wb, AA)
    E = torch.einsum("bsik,bsjl->bijkl", WAA, BB.conj()).reshape(-1, 4, 4)
    return AA, WAA, BB, E


def _fwd_plain(As, Bs, Wb, iters, with_left):
    """Plain version of K4: -> lam (B,), v (B, 4) and, with ``with_left``,
    w (B, 4) (else None), w read off the conjugate transpose of the same
    power (``_left_vector``; the JAX kernel squares E^dag a second time)."""
    _, _, _, E = _build(As, Bs, Wb)
    M = _squarings(E, iters)  # one chain for both vectors, as K4 squares
    lam, v = _extract_eigpair(E, M)
    return lam, v, _left_vector(M) if with_left else None


def _bwd_plain(As, Bs, Wb, lam, v, u, ct):
    """Plain version of K5: the adjoint of -|lam| at cotangent ct (B,),
    u the left eigenvector -> (Abar, Bbar, per-element Wbar (B, 4, 4)) in
    the JAX pairing convention."""
    AA, WAA, BB, _ = _build(As, Bs, Wb)
    n2 = lam.real.square() + lam.imag.square()
    d = (u.conj() * v).sum(-1)  # u^dag v
    dn2 = d.real.square() + d.imag.square()
    # coef = -ct (conj(lam)/|lam|) / (u^dag v), floors of tdvp_fused.py:288-290
    coef = -ct.to(lam.dtype) * lam.conj() * torch.rsqrt(torch.clamp(n2, min=1e-30)) * d.conj() / torch.clamp(
        dn2, min=1e-30
    )
    K = (coef[:, None] * u.conj())[:, :, None] * v[:, None, :]  # (B, (ij), (kl))
    K = K.reshape(-1, 2, 2, 2, 2)  # (B, i, j, k, l)
    P = torch.einsum("bijkl,bsjl->bsik", K, BB.conj())  # pairs dWAA
    C = torch.einsum("bijkl,bsik->bsjl", K, WAA).conj()  # pairs dBB
    Q = torch.einsum("bsik,bst->btik", P, Wb)  # pairs dAA
    Wbar = torch.einsum("bsik,btik->bst", P, AA)
    return _aa_adjoint(Q, As), _aa_adjoint(C, Bs), Wbar


# ---------------------------------------------------------------------------
# kernel launches
# ---------------------------------------------------------------------------


def _w_operand(W, B):
    """W as the kernels take it: (pointer tensor, stride 0 shared / 16 batched)."""
    if W.dim() == 2:
        _lib.require(W, "W", torch.complex64, (4, 4))
        return W.contiguous(), 0
    _lib.require(W, "W", torch.complex64, (B, 4, 4))
    return W.contiguous(), 16


def _fwd_cuda(As, Bs, W, iters, with_left):
    """K4: As, Bs (B,2,2,2), W (4,4) or (B,4,4), all complex64 CUDA ->
    lam, v and, with ``with_left``, w (else None)."""
    B = As.shape[0]
    _lib.require(As, "As", torch.complex64, (B, 2, 2, 2))
    _lib.require(Bs, "Bs", torch.complex64, (B, 2, 2, 2))
    W, w_stride = _w_operand(W, B)
    As, Bs = As.contiguous(), Bs.contiguous()
    lam = torch.empty(B, dtype=torch.complex64, device=As.device)
    v = torch.empty(B, 4, dtype=torch.complex64, device=As.device)
    w = torch.empty(B, 4, dtype=torch.complex64, device=As.device) if with_left else None
    if B:
        with torch.cuda.device(As.device):
            rc = _lib.lib().qmps_tdvp_fwd(
                As.data_ptr(), Bs.data_ptr(), W.data_ptr(), w_stride,
                lam.data_ptr(), v.data_ptr(), w.data_ptr() if with_left else None,
                B, iters, int(with_left), torch.cuda.current_stream().cuda_stream,
            )
        _lib.check(rc, "tdvp_fwd")
        _lib.count("tdvp_fwd")
    return lam, v, w


def _bwd_cuda(As, Bs, W, lam, v, u, ct):
    """K5: the forward's tensors, the left vector u and ct (B,) ->
    (Abar, Bbar, per-element Wbar (B, 4, 4)) complex64, JAX pairing
    convention."""
    B = As.shape[0]
    _lib.require(As, "As", torch.complex64, (B, 2, 2, 2))
    _lib.require(Bs, "Bs", torch.complex64, (B, 2, 2, 2))
    _lib.require(lam, "lam", torch.complex64, (B,))
    _lib.require(v, "v", torch.complex64, (B, 4))
    _lib.require(u, "u", torch.complex64, (B, 4))
    W, w_stride = _w_operand(W, B)
    ct = ct.to(torch.float32).expand(B).contiguous()
    As, Bs, lam, v, u = (t.contiguous() for t in (As, Bs, lam, v, u))
    Abar = torch.empty(B, 2, 2, 2, dtype=torch.complex64, device=As.device)
    Bbar = torch.empty(B, 2, 2, 2, dtype=torch.complex64, device=As.device)
    Wbar = torch.empty(B, 4, 4, dtype=torch.complex64, device=As.device)
    if B:
        with torch.cuda.device(As.device):
            rc = _lib.lib().qmps_tdvp_bwd(
                As.data_ptr(), Bs.data_ptr(), W.data_ptr(), w_stride,
                v.data_ptr(), u.data_ptr(), lam.data_ptr(), ct.data_ptr(),
                Abar.data_ptr(), Bbar.data_ptr(), Wbar.data_ptr(),
                B, torch.cuda.current_stream().cuda_stream,
            )
        _lib.check(rc, "tdvp_bwd")
        _lib.count("tdvp_bwd")
    return Abar, Bbar, Wbar


# ---------------------------------------------------------------------------
# public face
# ---------------------------------------------------------------------------


class _TdvpObjective(torch.autograd.Function):
    @staticmethod
    def forward(ctx, As, Bs, W, iters, with_left):
        if As.device.type == "cpu":
            Wk = W.to(As.dtype)
            lam, v, w = _fwd_plain(As, Bs, Wk.expand(As.shape[0], 4, 4), iters, with_left)
        else:
            Wk = W.to(torch.complex64)
            lam, v, w = _fwd_cuda(As, Bs, Wk, iters, with_left)
        ctx.save_for_backward(As, Bs, Wk, lam, v, w)
        ctx.w_type = W.dtype
        return -lam.abs()

    @staticmethod
    @once_differentiable
    def backward(ctx, ct):
        As, Bs, Wk, lam, v, w = ctx.saved_tensors
        if w is None:
            raise RuntimeError(
                "tdvp_objective_fused: the forward skipped the left eigenvector because no "
                "input required a gradient when it ran"
            )
        if As.device.type == "cpu":
            Abar, Bbar, Wbar = _bwd_plain(As, Bs, Wk.expand(As.shape[0], 4, 4), lam, v, w, ct)
        else:
            Abar, Bbar, Wbar = _bwd_cuda(As, Bs, Wk, lam, v, w, ct)
        # torch's .grad of a real loss is conj(jax.grad): conjugate the JAX
        # pairing-convention cotangents; a shared W takes the batch sum, a
        # real W the real part
        if Wk.dim() == 2:
            Wbar = Wbar.sum(0)
        Wbar = Wbar.conj_physical() if ctx.w_type.is_complex else Wbar.real
        return Abar.conj_physical(), Bbar.conj_physical(), Wbar.to(ctx.w_type), None, None


def tdvp_objective_fused(As: torch.Tensor, Bs: torch.Tensor, W: torch.Tensor,
                         iters: int = 48) -> torch.Tensor:
    """Batched D = 2 TDVP objective -|lam|: (B, 2, 2, 2) x 2 and a shared
    (4, 4) or per-element (B, 4, 4) gate W -> (B,), differentiable in all
    three.

    CPU tensors run the plain PyTorch version at their own precision; CUDA
    tensors (complex64) run K4 forward and K5 backward.  The forward also
    solves for the left eigenvector only when a gradient will be taken.
    """
    with_left = torch.is_grad_enabled() and any(t.requires_grad for t in (As, Bs, W))
    return _TdvpObjective.apply(As, Bs, W, iters, with_left)
