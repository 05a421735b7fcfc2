"""Dense linear-algebra utilities (counterpart of ``qmps_tpu.core.linalg``),
batched over any leading dimensions except where a docstring says one
matrix.  Completion is QR-based with the JAX package's fixed filler
(``_filler``), so both packages complete an isometry to the same unitary."""
from __future__ import annotations

import math

import numpy as np
import torch


def cT(t: torch.Tensor) -> torch.Tensor:
    """Hermitian conjugate of the last two indices."""
    return t.mH


def _trace(m: torch.Tensor) -> torch.Tensor:
    return m.diagonal(dim1=-2, dim2=-1).sum(-1)


def direct_sum(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Block-diagonal direct sum of two matrices (qmps/tools.py:69)."""
    return torch.block_diag(A, B)


def from_real_vector(v: torch.Tensor) -> torch.Tensor:
    """(re..., im...) -> complex vector (qmps/tools.py:43)."""
    re, im = torch.chunk(torch.as_tensor(v), 2)
    return torch.complex(re, im)


def to_real_vector(A: torch.Tensor) -> torch.Tensor:
    """complex tensor -> (re..., im...) real vector (qmps/tools.py:49)."""
    return torch.cat([A.real.reshape(-1), A.imag.reshape(-1)])


def _filler(m: int, k: int) -> np.ndarray:
    """The fixed, seed-deterministic (m, m-k) complex filler of the QR
    completion (the JAX package's, seed for seed)."""
    rng = np.random.default_rng(20240517 + 1000 * m + k)
    return rng.standard_normal((m, m - k)) + 1j * rng.standard_normal((m, m - k))


def unitary_completion(iso: torch.Tensor) -> torch.Tensor:
    """Complete (..., m, k) isometries (orthonormal columns) to (..., m, m)
    unitaries whose first k columns are exactly ``iso``: QR of [iso | F]
    with the fixed filler F projected off iso's column space, the diagonal
    phases of R divided out (differentiable; qmps/tools.py:76-94 used a
    null space)."""
    m, k = iso.shape[-2:]
    if m == k:
        return iso
    F = torch.from_numpy(_filler(m, k)).to(iso.device, iso.dtype)
    F = F - iso @ (iso.mH @ F)  # (..., m, m - k)
    Q, R = torch.linalg.qr(torch.cat([iso, F], -1))
    d = R.diagonal(dim1=-2, dim2=-1)
    return Q * (d / d.abs())[..., None, :]


def row_completion(rows: torch.Tensor) -> torch.Tensor:
    """Complete (..., k, m) orthonormal rows to (..., m, m) unitaries whose
    first k rows are exactly ``rows``."""
    return unitary_completion(rows.mH).mH


def polar(A: torch.Tensor):
    """Polar decomposition A = U P by SVD (differentiable)."""
    u, s, vh = torch.linalg.svd(A, full_matrices=False)
    return u @ vh, vh.mH @ (s[..., :, None].to(A.dtype) * vh)


def eye_like(A: torch.Tensor) -> torch.Tensor:
    return torch.eye(A.shape[-1], dtype=A.dtype, device=A.device)


def frob_norm(A: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.sum(A.abs() ** 2))


def random_unitary(generator: torch.Generator | None, n: int, dtype=torch.complex128,
                   device="cpu") -> torch.Tensor:
    """Haar-ish random (n, n) unitary: QR of a complex gaussian drawn from
    ``generator`` on the CPU, diagonal phases of R divided out."""
    x = torch.randn(2, n, n, generator=generator, dtype=torch.float64)
    Q, R = torch.linalg.qr(torch.complex(x[0], x[1]).to(device, dtype))
    d = R.diagonal()
    return Q * (d / d.abs())[None, :]


def nsphere(v: torch.Tensor) -> torch.Tensor:
    """Unit vector on S^n from n hyperspherical angles (the reference's
    Nsphere, qmps/time_evolve_tools.py:25-36) as one cumprod:
    x_k = cos(v_k) prod_{j<k} sin(v_j) for k < n, x_n = prod_j sin(v_j)."""
    v = torch.as_tensor(v)
    sines = torch.cumprod(torch.sin(v), 0)
    prefix = torch.cat([torch.ones(1, dtype=v.dtype, device=v.device), sines[:-1]])
    return torch.cat([prefix * torch.cos(v), sines[-1:]])


def split_ns(x: torch.Tensor, n: int) -> torch.Tensor:
    """Chunk a flat parameter vector into consecutive groups of n
    (qmps/tools.py:161-174): (k*n,) -> (k, n)."""
    x = torch.as_tensor(x)
    if x.shape[0] % n:
        raise ValueError(f"length {x.shape[0]} is not a multiple of {n}")
    return x.reshape(-1, n)


def spectral_radius_dense(E: torch.Tensor, n_squarings: int = 30) -> torch.Tensor:
    """rho(E) = max |eigenvalue| by Gelfand's formula through the repeated
    squaring's normalisation factors: with M_0 = E/||E|| and M_{k+1} =
    M_k^2 / s_k, s_k = ||M_k^2||_F, log rho = log||E|| + sum_k log(s_k) /
    2^(k+1).  Right where the dominant eigenvalue is a complex-conjugate
    pair, which has no single eigenvector for the squaring to reach."""
    tiny = torch.finfo(E.real.dtype).tiny
    nrm = torch.linalg.matrix_norm(E)
    M = E / nrm.clamp(min=tiny)[..., None, None]
    acc = torch.zeros_like(nrm)
    for k in range(n_squarings):
        M = M @ M
        s = torch.linalg.matrix_norm(M)
        M = M / s.clamp(min=tiny)[..., None, None]
        acc = acc + torch.log(s) / 2.0 ** (k + 1)
    return nrm * torch.exp(acc)


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


def _start_read(M: torch.Tensor) -> torch.Tensor:
    """The unit vector M v0 of a normalized power M: v0 = vec(I) when n is
    a square (it has weight on the fixed point of a transfer operator),
    else all ones, with the chirp where that was (near-)orthogonal to the
    dominant eigenspace."""
    n = M.shape[-1]
    d = math.isqrt(n)
    if d * d == n:
        v0 = torch.eye(d, dtype=M.dtype, device=M.device).reshape(-1)
    else:
        v0 = torch.ones(n, dtype=M.dtype, device=M.device)
    v = M @ v0
    alt = M @ _chirp(n, M.dtype, M.device)
    use_alt = torch.linalg.vector_norm(v, dim=-1) < 1e-8 * torch.linalg.vector_norm(alt, dim=-1)
    v = torch.where(use_alt[..., None], alt, v)
    return v / torch.linalg.vector_norm(v, dim=-1, keepdim=True)


def dominant_eig_dense(E: torch.Tensor, n_squarings: int = 40, left: bool = False):
    """Dominant eigenpair of (..., n, n) matrices by repeated squaring.

    Returns (lam (...,), v (..., n)) with v unit-norm (arbitrary phase);
    with ``left`` also the left vector w (E^dag w = conj(lam) w), read off
    the conjugate transpose of the same power ((E^dag)^2 = (E^2)^dag), so
    one chain serves both.  The chain runs as one batched product a
    squaring over the flattened batch.
    """
    n = E.shape[-1]
    M = (E / _fro(E)).reshape(-1, n, n)
    for _ in range(n_squarings):
        M = torch.bmm(M, M)
        M = M / torch.linalg.vector_norm(M, dim=(-2, -1), keepdim=True)
    M = M.reshape(E.shape)
    v = _start_read(M)
    lam = (v.conj() * (E @ v[..., None])[..., 0]).sum(-1)
    if left:
        return lam, v, _start_read(M.mH)
    return lam, v
