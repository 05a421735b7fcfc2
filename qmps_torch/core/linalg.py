"""Dense linear-algebra utilities (counterpart of ``qmps_tpu.core.linalg``),
batched over any leading dimensions."""
from __future__ import annotations

import math

import torch


def cT(t: torch.Tensor) -> torch.Tensor:
    """Hermitian conjugate of the last two indices."""
    return t.mH


def _trace(m: torch.Tensor) -> torch.Tensor:
    return m.diagonal(dim1=-2, dim2=-1).sum(-1)


def rotate_to_hermitian(r: torch.Tensor) -> torch.Tensor:
    """Remove the global phase from matrices that are hermitian up to a
    phase: for r = e^{i phi} h, tr(r r) = e^{2 i phi} |h|_F^2 gives phi up
    to pi, and the sign is fixed so that tr(h) >= 0."""
    phase = torch.exp(-0.5j * torch.angle(_trace(r @ r)))
    h = r * phase[..., None, None]
    return torch.where((_trace(h).real < 0)[..., None, None], -h, h)


def _chirp(n: int, dtype, device=None) -> torch.Tensor:
    """The fixed pseudo-random start vector cos(0.7 k + 0.3) + i sin(1.3 k + 1.1)."""
    k = torch.arange(n, dtype=torch.float64)
    return torch.complex(torch.cos(0.7 * k + 0.3), torch.sin(1.3 * k + 1.1)).to(device, dtype)


def _fro(M: torch.Tensor) -> torch.Tensor:
    return torch.linalg.matrix_norm(M)[..., None, None]


def dominant_eig_dense(E: torch.Tensor, n_squarings: int = 40):
    """Dominant eigenpair of (..., n, n) matrices by repeated squaring.

    Returns (lam (...,), v (..., n)) with v unit-norm (arbitrary phase).
    The start vector is vec(I) when n is a square (it has weight on the
    fixed point of a transfer operator), else all ones, with the chirp as
    the fallback where it was (near-)orthogonal to the dominant eigenspace.
    """
    n = E.shape[-1]
    M = E / _fro(E)
    for _ in range(n_squarings):
        M = M @ M
        M = M / _fro(M)
    d = math.isqrt(n)
    if d * d == n:
        v0 = torch.eye(d, dtype=E.dtype, device=E.device).reshape(-1)
    else:
        v0 = torch.ones(n, dtype=E.dtype, device=E.device)
    v = M @ v0
    alt = M @ _chirp(n, E.dtype, E.device)
    use_alt = torch.linalg.vector_norm(v, dim=-1) < 1e-8 * torch.linalg.vector_norm(alt, dim=-1)
    v = torch.where(use_alt[..., None], alt, v)
    v = v / torch.linalg.vector_norm(v, dim=-1, keepdim=True)
    lam = (v.conj() * (E @ v[..., None])[..., 0]).sum(-1)
    return lam, v
