"""Batched dominant eigenpair of small transfer matrices (kernel K1).

The environment solve of a D = 2 uniform MPS is the dominant eigenpair of
a batch of 4 x 4 complex transfer matrices.  ``dominant_eig_batched`` runs
it by repeated squaring (default; error ~ |l2/l1|^(2^iters), machine
precision for any nontrivial gap) or by power iteration.

For a CUDA tensor it launches the hand-written kernel
``csrc/pallas_power.cu`` (float32, one thread per matrix), which replaces
``qmps_tpu/kernels/pallas_power.py::_squaring_kernel`` and
``::_power_kernel``; for a CPU tensor it runs ``_dominant_eig_plain``, the
same algorithm in plain PyTorch at the tensor's own precision.
"""
from __future__ import annotations

import math

import torch

from . import _lib

_METHODS = {"squaring": 0, "power": 1}


def _chirps(N: int):
    """The two fixed start vectors of the squaring solve (the constants of
    qmps_tpu/kernels/pallas_power.py::_chirps)."""
    c1 = [(math.cos(0.7 * j + 0.3), math.sin(1.3 * j + 1.1)) for j in range(N)]
    c2 = [(math.cos(1.9 * j + 0.8), math.sin(0.5 * j + 2.0)) for j in range(N)]
    return c1, c2


def _rsqrt_clamped(n2: torch.Tensor) -> torch.Tensor:
    return torch.rsqrt(torch.clamp(n2, min=1e-30))


def _sq_norm(x: torch.Tensor, dims) -> torch.Tensor:
    return (x.real.square() + x.imag.square()).sum(dims, keepdim=True)


def _dominant_eig_plain(E: torch.Tensor, iters: int = 48, method: str = "squaring"):
    """Plain PyTorch version of the K1 kernel: (B, 4, 4) complex ->
    (lam (B,), v (B, 4)), the same steps as the kernel."""
    if method == "squaring":
        M = E
        for _ in range(iters):
            M = M @ M
            M = M * _rsqrt_clamped(_sq_norm(M, (-2, -1)))
        N = E.shape[-1]
        v1, v2 = (
            M @ torch.tensor([complex(*z) for z in c], dtype=E.dtype, device=E.device)
            for c in _chirps(N)
        )
        use1 = _sq_norm(v1, -1) >= _sq_norm(v2, -1)
        v = torch.where(use1, v1, v2)
        v = v * _rsqrt_clamped(_sq_norm(v, -1))
    elif method == "power":
        dither = torch.tensor(
            [0.37 * math.cos(1.7 * i + 0.3) for i in range(E.shape[-1])],
            dtype=E.real.dtype, device=E.device,
        )
        v = E[:, :, 0] + dither
        for _ in range(iters):
            w = (E @ v[..., None])[..., 0]
            v = w * _rsqrt_clamped(_sq_norm(w, -1))
    else:
        raise ValueError(f"method must be 'squaring' or 'power', got {method!r}")
    lam = (v.conj() * (E @ v[..., None])[..., 0]).sum(-1)  # Rayleigh, v unit norm
    return lam, v


def _dominant_eig_cuda(E: torch.Tensor, iters: int, method: str):
    """Launch K1 on a (B, 4, 4) complex64 CUDA tensor."""
    _lib.require(E, "E", torch.complex64, (None, 4, 4))
    E = E.contiguous()
    B = E.shape[0]
    lam = torch.empty(B, dtype=E.dtype, device=E.device)
    v = torch.empty(B, 4, dtype=E.dtype, device=E.device)
    if B:
        with torch.cuda.device(E.device):
            rc = _lib.lib().qmps_dominant_eig(
                E.data_ptr(), lam.data_ptr(), v.data_ptr(), B, iters, _METHODS[method],
                torch.cuda.current_stream().cuda_stream,
            )
        _lib.check(rc, "dominant_eig")
        _lib.launches["dominant_eig"] += 1
    return lam, v


def dominant_eig_batched(E: torch.Tensor, iters: int = 48, method: str = "squaring"):
    """(B, 4, 4) complex -> (lam (B,), v (B, 4)): dominant eigenvalue and
    unit right eigenvector of each matrix.

    A CPU tensor runs the plain version at its own precision; a CUDA tensor
    (complex64) launches the K1 kernel, or raises.
    """
    if method not in _METHODS:
        raise ValueError(f"method must be 'squaring' or 'power', got {method!r}")
    if E.dim() != 3 or E.shape[-1] != E.shape[-2]:
        raise ValueError(f"expected a (B, N, N) batch, got {tuple(E.shape)}")
    if E.shape[-1] != 4:
        raise NotImplementedError(
            "dominant_eig_batched is ported for N = 4 (D = 2) only; N > 4 waits for "
            "the looped and MXU squaring kernels (ROADMAP.md, 'TPU kernels to port': K7, K8)"
        )
    if E.device.type == "cpu":
        return _dominant_eig_plain(E, iters, method)
    return _dominant_eig_cuda(E, iters, method)
