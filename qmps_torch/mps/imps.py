"""Uniform MPS (counterpart of ``qmps_tpu.mps.imps``).

Ported: ``merge``, the gauge helpers (``_cholesky_psd``, ``_qr_pos``,
``_pinv_tri``), ``left_orthogonalise``, ``iMPS`` with its constructor,
indexing, ``blocked``, ``d``, ``D``, ``left_canonicalise`` (1-site and
n-site cells) and ``overlap``, and ``Map`` with ``asmatrix`` and
``right_fixed_point``.  The other members (energies, correlators,
``truncated``, ``right_canonicalise``, ``mixed`` and so on) wait
(ROADMAP.md, item 4).  A tensor A has shape (d, D, D) = (physical, left,
right); ``merge`` is batched over leading dimensions, the rest takes one
state.
"""
from __future__ import annotations

from typing import Sequence

import torch

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
    return torch.linalg.cholesky(M + eps * torch.eye(M.shape[-1], dtype=M.dtype, device=M.device))


def _qr_pos(mat: torch.Tensor):
    """QR with the diagonal of R rotated positive-real: a deterministic
    gauge (the complex QR phase ambiguity otherwise makes canonical forms
    seed-dependent)."""
    Q, R = torch.linalg.qr(mat)
    dg = torch.diagonal(R)
    tiny = torch.finfo(dg.real.dtype).tiny
    ph = dg / torch.where(dg.abs() > tiny, dg.abs(), torch.ones_like(dg.abs()))
    return Q * ph[None, :], R * ph.conj()[:, None]


def _pinv_tri(M: torch.Tensor, rcond: float | None = None) -> torch.Tensor:
    """SVD pseudo-inverse of a gauge matrix with a relative cutoff, by
    default eps**0.75 of the type (~7e-6 in float32, ~1e-12 in float64):
    the null directions of a rank-deficient gauge matrix are dropped
    instead of inverted (imps.py:66-82)."""
    u, s, vh = torch.linalg.svd(M)
    if rcond is None:
        rcond = float(torch.finfo(M.real.dtype).eps) ** 0.75
    cut = rcond * s[0]
    sinv = torch.where(s > cut, 1.0 / torch.clamp(s, min=cut), torch.zeros_like(s))
    return vh.mH @ (sinv[:, None].to(M.dtype) * u.mH)


def _unit_trace_herm(x: torch.Tensor) -> torch.Tensor:
    x = (x + x.mH) / 2
    return x / _trace(x)


def left_orthogonalise(A: torch.Tensor, dense: bool = True):
    """Gauge A to left-canonical form.

    Returns (AL, L_upper, eta): sum AL^dag AL = I, where l = L^dag L is the
    dominant left fixed point of the transfer operator and eta its
    eigenvalue (the state's norm per site before rescaling).
    """
    eta, l = tr.left_fixed_point(A, A, dense=dense)
    M = _cholesky_psd(_unit_trace_herm(l)).mH  # upper; l = M^dag M
    AL = torch.einsum("ij,sjk,kl->sil", M, A, _pinv_tri(M)) / torch.sqrt(eta.real)
    return AL, M, eta


class iMPS:
    """Uniform MPS with a (usually 1-site) unit cell, xmps-compatible API."""

    def __init__(self, data: Sequence[torch.Tensor] | None = None):
        self.data = tuple(torch.as_tensor(a) for a in data) if data is not None else ()

    def __getitem__(self, i):
        return self.data[i]

    def __len__(self):
        return len(self.data)

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
