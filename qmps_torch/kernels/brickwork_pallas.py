"""Fused batched brickwork overlap (kernel K6).

<psi(U1', U2')| Ml (x) W (x) Mr |psi(U1, U2)> for a batch of brick pairs,
the same contract as ``qmps_tpu.kernels.brickwork_pallas.
manifold_overlap_pallas``: U1, U2, U1p, U2p (B, 4, 4) complex, Mr, Ml
(B, 2, 2), W (16, 16) shared -> (B,) complex.  Forward only.

For CUDA tensors (complex64) it is one launch of K6
(``csrc/brickwork_overlap.cu``, replacing ``_overlap_kernel``); for CPU
tensors the plain PyTorch version, ``brickwork_fast.
manifold_overlap_batched``, runs at the tensors' own precision.  The JAX
function's ``tile_rows`` and ``interpret`` are TPU knobs and have no
counterpart.
"""
from __future__ import annotations

import torch

from . import _lib
from .brickwork_fast import manifold_overlap_batched

__all__ = ["manifold_overlap_pallas"]


def _overlap_cuda(U1, U2, U1p, U2p, Mr, Ml, W) -> torch.Tensor:
    """K6 on complex64 CUDA tensors."""
    B = U1.shape[0]
    for t, name, shape in ((U1, "U1", (B, 4, 4)), (U2, "U2", (B, 4, 4)), (U1p, "U1p", (B, 4, 4)),
                           (U2p, "U2p", (B, 4, 4)), (Mr, "Mr", (B, 2, 2)), (Ml, "Ml", (B, 2, 2)),
                           (W, "W", (16, 16))):
        _lib.require(t, name, torch.complex64, shape)
    # the kernel reads memory as it lies: resolve lazy conjugations first
    c2 = U2[:, :, 0].resolve_conj().contiguous()
    r2 = U2p[:, :, 0].conj().resolve_conj().contiguous()
    U1, U1p, Ml, Mr, W = (t.resolve_conj().contiguous() for t in (U1, U1p, Ml, Mr, W))
    out = torch.empty(B, dtype=torch.complex64, device=U1.device)
    if B:
        with torch.cuda.device(U1.device):
            rc = _lib.lib().qmps_brickwork_overlap(
                U1.data_ptr(), c2.data_ptr(), U1p.data_ptr(), r2.data_ptr(), Ml.data_ptr(),
                Mr.data_ptr(), W.data_ptr(), out.data_ptr(), B, torch.cuda.current_stream().cuda_stream,
            )
        _lib.check(rc, "brickwork_overlap")
        _lib.launches["brickwork_overlap"] += 1
    return out


def manifold_overlap_pallas(U1, U2, U1p, U2p, Mr, Ml, W) -> torch.Tensor:
    """Fused batched <psi(U1', U2')| Ml (x) W (x) Mr |psi(U1, U2)>: K6 for
    CUDA tensors, the plain version for CPU tensors."""
    if U1.device.type == "cpu":
        return manifold_overlap_batched(U1, U2, U1p, U2p, Mr, Ml, W)
    return _overlap_cuda(U1, U2, U1p, U2p, Mr, Ml, W)
