"""Batched dominant eigenpair of small transfer matrices (kernels K1, K7, K8).

The environment solve of a uniform MPS of bond dimension D is the dominant
eigenpair of a batch of N x N complex transfer matrices, N = D^2.
``dominant_eig_batched`` runs it by repeated squaring (default; error
~ |l2/l1|^(2^iters), machine precision for any nontrivial gap) or, at N = 4,
by power iteration.  ``dominant_eigval_batched`` is its differentiable face.

For a CUDA tensor (complex64) it launches hand-written kernels:
- N = 4 (D = 2): ``csrc/pallas_power.cu`` (K1, a quad of lanes or one
  thread a matrix by batch, the whole solve in registers, the left
  eigenvector on request off the same power), which replaces
  ``qmps_tpu/kernels/pallas_power.py::_squaring_kernel`` and
  ``::_power_kernel``;
- 4 < N <= 16 (D = 3, 4) and N > 16 (D >= 5): ``csrc/matpow.cu`` (K7:
  below N = 15 on the CUDA cores, a block of the product a lane, four or
  eight lanes a matrix; from N = 15 one warp a matrix on the tensor cores in
  3xTF32; K8 on the tensor cores in 3xTF32, one block a matrix up to
  N = 64, above it a grid of 64 x 64 output tiles over the whole batch, one
  launch a squaring, the power in a workspace), which replace
  ``::_matpow_kernel_looped``
  and ``::_squaring_kernel_mxu``.  They return the normalised power
  E^(2^iters); ``_extract_eigpair`` reads (lam, v) off it in plain PyTorch,
  as the JAX package does in XLA, and ``_left_vector`` reads the left
  eigenvector off the same power's conjugate transpose, where the JAX
  package squares E^dag in a second chain.
For a CPU tensor the plain versions below run the same algorithms at the
tensor's own precision.
"""
from __future__ import annotations

import functools
import math

import torch
from torch.autograd.function import once_differentiable

from . import _lib

_METHODS = {"squaring": 0, "power": 1}
#: largest N of K7 (one warp a matrix); K8 takes every larger N
MAX_SMALL_N = 16
#: largest N whose power K8 keeps in shared memory; above it, in a workspace
MAX_SHARED_N = 64
#: K8's output tile above MAX_SHARED_N, and the unit its planes are padded to
TILE = 64


def matpow_work_floats(B: int, N: int) -> int:
    """Floats of K8's workspace above N = 64 (csrc/matpow.cu::launch_tiles):
    two sets of float32 planes R, I (B, 2, NP, NP), NP = N rounded up to 64,
    and two sets of the tiles' partial norms (B, (NP / 64)^2)."""
    NP = -(-N // TILE) * TILE
    return 2 * (B * 2 * NP * NP + B * (NP // TILE) ** 2)


def _chirps(N: int):
    """The two fixed start vectors of the squaring solve (the constants of
    qmps_tpu/kernels/pallas_power.py::_chirps)."""
    c1 = [(math.cos(0.7 * j + 0.3), math.sin(1.3 * j + 1.1)) for j in range(N)]
    c2 = [(math.cos(1.9 * j + 0.8), math.sin(0.5 * j + 2.0)) for j in range(N)]
    return c1, c2


@functools.lru_cache(maxsize=None)
def _chirp_matrix(N: int, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """The two chirps as the columns of one (N, 2) tensor, built once per
    (N, dtype, device)."""
    c1, c2 = _chirps(N)
    return torch.tensor([[complex(*a), complex(*b)] for a, b in zip(c1, c2)], dtype=dtype, device=device)


def _rsqrt_clamped(n2: torch.Tensor) -> torch.Tensor:
    return torch.rsqrt(torch.clamp(n2, min=1e-30))


def _sq_norm(x: torch.Tensor, dims) -> torch.Tensor:
    return (x.real.square() + x.imag.square()).sum(dims, keepdim=True)


def _normalised(M: torch.Tensor) -> torch.Tensor:
    """M / ||M||_F per matrix, the norm floored as the kernels floor it."""
    return M * _rsqrt_clamped(_sq_norm(M, (-2, -1)))


def _chirp_read(M: torch.Tensor) -> torch.Tensor:
    """The dominant eigenvector read off a converged power M (B, N, N):
    M c for the two chirps, the larger wins, normalised (a zero M gives 0)."""
    V = M @ _chirp_matrix(M.shape[-1], M.dtype, M.device)  # (B, N, 2)
    n2 = _sq_norm(V, -2)
    v = torch.where(n2[..., 0] >= n2[..., 1], V[..., 0], V[..., 1])
    return v * _rsqrt_clamped(_sq_norm(v, -1))


def _extract_eigpair(E: torch.Tensor, M: torch.Tensor):
    """(lam (B,), v (B, N)) from the converged power M of E
    (pallas_power.py::_extract_eigpair): v the chirp read of M; lam = v^dag
    E v.  A zero M gives v = 0, lam = 0."""
    v = _chirp_read(M)
    lam = (v.conj() * (E @ v[..., None])[..., 0]).sum(-1)  # Rayleigh, v unit norm
    return lam, v


def _left_vector(M: torch.Tensor) -> torch.Tensor:
    """The left eigenvector w of E (E^dag w = conj(lam) w) from the power M
    of E alone: every normalised power of E^dag is the conjugate transpose
    of the same power of E ((E^dag)^2 = (E^2)^dag, ||X^dag||_F = ||X||_F),
    so w is the chirp read of M^dag, the vector that a second squaring
    chain on E^dag would give."""
    return _chirp_read(M.mH)


def _squarings(M: torch.Tensor, iters: int) -> torch.Tensor:
    """``iters`` times M <- M M / ||M M||_F per matrix: the squaring chain
    of every plain solve (K1, K4, K7, K8)."""
    for _ in range(iters):
        M = _normalised(M @ M)
    return M


def _dominant_eig_plain(E: torch.Tensor, iters: int = 48, method: str = "squaring"):
    """Plain PyTorch version of the K1 kernel: (B, N, N) complex -> (lam
    (B,), v (B, N)), the same steps as the kernel."""
    if method == "squaring":
        return _extract_eigpair(E, _squarings(E, iters))
    if method != "power":
        raise ValueError(f"method must be 'squaring' or 'power', got {method!r}")
    dither = torch.tensor(
        [0.37 * math.cos(1.7 * i + 0.3) for i in range(E.shape[-1])],
        dtype=E.real.dtype, device=E.device,
    )
    v = E[:, :, 0] + dither
    for _ in range(iters):
        w = (E @ v[..., None])[..., 0]
        v = w * _rsqrt_clamped(_sq_norm(w, -1))
    lam = (v.conj() * (E @ v[..., None])[..., 0]).sum(-1)
    return lam, v


def _matrix_power_plain(E: torch.Tensor, iters: int) -> torch.Tensor:
    """Plain PyTorch version of K7 and K8: E / ||E||_F, then ``iters`` times
    M <- M M / ||M M||_F per matrix (the order of steps of
    ``_matpow_kernel_looped``), at the tensor's own precision."""
    return _squarings(_normalised(E), iters)


@_lib.launcher("dominant_eig")
def _dominant_eig_cuda(E: torch.Tensor, iters: int, method: str, left: bool = False):
    """Launch K1 on a (B, 4, 4) complex64 CUDA tensor -> (lam, v), and with
    ``left`` (squaring only) also w, the left eigenvector read off the same
    power's conjugate transpose."""
    _lib.require(E, "E", torch.complex64, (None, 4, 4))
    if left and method != "squaring":
        raise ValueError("K1 reads the left eigenvector off the squaring chain's power only")
    E = E.resolve_conj().contiguous()  # a lazy E^dag is materialised first
    B = E.shape[0]
    lam = torch.empty(B, dtype=E.dtype, device=E.device)
    v = torch.empty(B, 4, dtype=E.dtype, device=E.device)
    w = torch.empty(B, 4, dtype=E.dtype, device=E.device) if left else None
    if B:
        _lib.launch("dominant_eig", E.device, E, lam, v, w, B, iters, _METHODS[method])
    return (lam, v, w) if left else (lam, v)


def _matrix_power_cuda(E: torch.Tensor, iters: int) -> torch.Tensor:
    """Launch K7 (4 < N <= 16) or K8 (N > 16) on a (B, N, N) complex64 CUDA
    tensor -> the normalised power, (B, N, N) complex64."""
    return (_matpow_small_cuda if E.shape[-1] <= MAX_SMALL_N else _matpow_large_cuda)(E, iters)


def _matpow_operands(E: torch.Tensor):
    """(E contiguous, the power's output) of a K7 or K8 launch."""
    _lib.require(E, "E", torch.complex64, (None, None, None))
    E = E.resolve_conj().contiguous()  # a lazy E^dag is materialised first
    return E, torch.empty_like(E)


@_lib.launcher("matpow_small")
def _matpow_small_cuda(E: torch.Tensor, iters: int) -> torch.Tensor:
    E, M = _matpow_operands(E)
    B, N = E.shape[0], E.shape[-1]
    if B:
        _lib.launch("matpow_small", E.device, E, M, B, N, iters)
    return M


@_lib.launcher("matpow_large")
def _matpow_large_cuda(E: torch.Tensor, iters: int) -> torch.Tensor:
    E, M = _matpow_operands(E)
    B, N = E.shape[0], E.shape[-1]
    if B:
        work = (torch.empty(matpow_work_floats(B, N), dtype=torch.float32, device=E.device)
                if N > MAX_SHARED_N else None)
        _lib.launch("matpow_large", E.device, E, M, work, B, N, iters)
    return M


def _matrix_power(E: torch.Tensor, iters: int) -> torch.Tensor:
    """The normalised power E^(2^iters) of a (B, N, N) batch, N > 4: the
    plain version for a CPU tensor, K7 or K8 for a CUDA one."""
    return _matrix_power_plain(E, iters) if E.device.type == "cpu" else _matrix_power_cuda(E, iters)


def _check_batch(E: torch.Tensor) -> None:
    if E.dim() != 3 or E.shape[-1] != E.shape[-2]:
        raise ValueError(f"expected a (B, N, N) batch, got {tuple(E.shape)}")


def dominant_eig_batched(E: torch.Tensor, iters: int = 48, method: str = "squaring"):
    """(B, N, N) complex -> (lam (B,), v (B, N)): dominant eigenvalue and
    unit right eigenvector (arbitrary phase) of each matrix.

    A CPU tensor runs the plain versions at its own precision; a CUDA tensor
    (complex64) launches K1 at N = 4, K7 at 4 < N <= 16 and K8 above, or
    raises.  ``method="power"`` exists for N <= 4 only, as in the JAX package.
    """
    if method not in _METHODS:
        raise ValueError(f"method must be 'squaring' or 'power', got {method!r}")
    _check_batch(E)
    N = E.shape[-1]
    if N <= 4:
        if E.device.type == "cpu":
            return _dominant_eig_plain(E, iters, method)
        if N < 4:
            raise ValueError(f"the CUDA kernels take N >= 4 (K1 is written for N = 4), got N = {N}")
        return _dominant_eig_cuda(E, iters, method)
    if method != "squaring":
        raise ValueError("the N > 4 paths implement method='squaring' only")
    return _extract_eigpair(E, _matrix_power(E, iters))


class _DominantEigvalBatched(torch.autograd.Function):
    @staticmethod
    def forward(ctx, E, iters):
        if not ctx.needs_input_grad[0]:
            return dominant_eig_batched(E, iters)[0]
        _check_batch(E)
        # one power of E gives v and w (E^dag w = conj(lam) w): at N = 4 K1
        # reads both off its power in registers
        if E.shape[-1] <= 4 and E.device.type != "cpu":
            lam, v, w = _dominant_eig_cuda(E, iters, "squaring", left=True)
        else:
            M = _squarings(E, iters) if E.shape[-1] <= 4 else _matrix_power(E, iters)
            lam, v = _extract_eigpair(E, M)
            w = _left_vector(M)
        ctx.save_for_backward(v, w)
        ctx.e_type = E.dtype
        return lam

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        v, w = ctx.saved_tensors
        # conj of pallas_power.py::_dom_eigval_batched_bwd at the conjugated
        # cotangent: JAX's Ebar = ct conj(w) v^T / (w^dag v)
        denom = (w.conj() * v).sum(-1)
        Ebar = (g / denom.conj())[:, None, None] * w[:, :, None] * v.conj()[:, None, :]
        return Ebar.to(ctx.e_type), None


def dominant_eigval_batched(E: torch.Tensor, iters: int = 48) -> torch.Tensor:
    """Dominant eigenvalues of a (B, N, N) complex batch, differentiable.

    Forward: ``dominant_eig_batched`` (on the card K1, K7 or K8 by N); when
    a gradient will be taken, one power of E gives the right eigenvector
    and, through its conjugate transpose, the left one (at N = 4 in one K1
    launch on E).  Backward: the rank-1 implicit adjoint
    dlam = (w^dag dE v) / (w^dag v), no further solve.
    """
    return _DominantEigvalBatched.apply(E, iters)
