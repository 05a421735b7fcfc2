"""Fused batched brickwork overlap (kernel K6).

<psi(U1', U2')| Ml (x) W (x) Mr |psi(U1, U2)> for a batch of brick pairs,
the same contract as ``qmps_tpu.kernels.brickwork_pallas.
manifold_overlap_pallas``: U1, U2, U1p, U2p (B, 4, 4) complex, Mr, Ml
(B, 2, 2), W (16, 16) shared -> (B,) complex.  Forward only.

For CUDA tensors (complex64) it is one launch of K6
(``csrc/brickwork_overlap.cu``, replacing ``_overlap_kernel``), and no
other kernel: K6 reads U2's and U2p's column 0 itself, and a tensor is
copied only where it is a lazy conjugate or not contiguous.  For CPU
tensors the plain PyTorch version, ``brickwork_fast.
manifold_overlap_batched``, runs at the tensors' own precision.  The JAX
function's ``tile_rows`` and ``interpret`` are TPU knobs and have no
counterpart.  ``_overlap_lane_map`` is K6's arithmetic in the kernel's own
order and lane map, the CPU tests' model of it.
"""
from __future__ import annotations

import torch

from . import _lib
from .brickwork_fast import manifold_overlap_batched

__all__ = ["manifold_overlap_pallas"]


def _dense(t: torch.Tensor) -> torch.Tensor:
    """t as the kernel reads memory: a lazy conjugate resolved and the
    result contiguous, each copy made only where it is needed."""
    if t.is_conj():
        t = t.resolve_conj()
    return t if t.is_contiguous() else t.contiguous()


def _overlap_operands(U1, U2, U1p, U2p, Mr, Ml, W):
    """K6's operands in its argument order (U1, U2, U1p, U2p, Ml, Mr, W):
    U2 and U2p whole, since the kernel takes their column 0 itself."""
    return tuple(_dense(t) for t in (U1, U2, U1p, U2p, Ml, Mr, W))


@_lib.launcher("brickwork_overlap")
def _overlap_cuda(U1, U2, U1p, U2p, Mr, Ml, W) -> torch.Tensor:
    """K6 on complex64 CUDA tensors: one launch, on the tensors' device."""
    B = U1.shape[0]
    c64, sq, m2 = torch.complex64, (B, 4, 4), (B, 2, 2)
    for t, name, shape in ((U1, "U1", sq), (U2, "U2", sq), (U1p, "U1p", sq), (U2p, "U2p", sq), (Mr, "Mr", m2),
                           (Ml, "Ml", m2), (W, "W", (16, 16))):
        _lib.require(t, name, c64, shape)
    ops = _overlap_operands(U1, U2, U1p, U2p, Mr, Ml, W)
    out = torch.empty(B, dtype=c64, device=U1.device)
    if B:
        _lib.launch("brickwork_overlap", U1.device, *ops, out, B)
    return out


def _sector_state(U, x0, mid, x5):
    """csrc/brickwork_overlap.cu::sector_state, batched: k = U C U^T (B, 4, 4)
    with C[(q1 q2), (q3 q4)] = x0[q1] mid[q2 * 2 + q3] x5[q4], as the sum
    over q3 of (U y_q3)(U z_q3)^T: alpha[j, q3] = (U y_q3)[j], y_q3[(q1 q2)] =
    x0[q1] mid[q2, q3]; omega[l, q3] = sum_q4 U[l, 2 q3 + q4] x5[q4]."""
    B = U.shape[0]
    y = (x0[:, :, None, None] * mid.reshape(B, 1, 2, 2)).reshape(B, 4, 2)
    alpha = U @ y
    omega = (U.reshape(B, 4, 2, 2) * x5[:, None, None, :]).sum(-1)
    return alpha @ omega.transpose(-1, -2)


def _lane_kets_bras(U1, U2, U1p, U2p, Mr, Ml):
    """K6's kets and bras as its lanes hold them, (B, 4, 16) each: lane t of
    an element's quad holds the sector (a, c) = (t >> 1, t & 1), its ket
    k = U1 C U1^T of c2 = U2[:, 0] and its bra b = conj(U1' C' U1'^T) of
    d = U2p[:, 0] with Ml and Mr folded into the outer factors
    (conjugated)."""
    c2, d = U2[:, :, 0], U2p[:, :, 0]
    kets, bras = [], []
    for t in range(4):
        a, c = t >> 1, t & 1
        kets.append(_sector_state(U1, c2[:, 2 * a:2 * a + 2], c2, c2[:, c::2]))
        x0 = Ml[:, 0, a, None].conj() * d[:, 0:2] + Ml[:, 1, a, None].conj() * d[:, 2:4]
        x5 = Mr[:, 0, c, None].conj() * d[:, 0::2] + Mr[:, 1, c, None].conj() * d[:, 1::2]
        bras.append(_sector_state(U1p, x0, d, x5).conj())
    return torch.stack(kets, 1).flatten(2), torch.stack(bras, 1).flatten(2)


def _overlap_lane_map(U1, U2, U1p, U2p, Mr, Ml, W) -> torch.Tensor:
    """K6's arithmetic in the kernel's order and lane map, in plain PyTorch:
    the overlap is the sum over an element's four sectors of b . (W k)."""
    kets, bras = _lane_kets_bras(U1, U2, U1p, U2p, Mr, Ml)
    return (bras * (kets @ W.T)).sum((1, 2))


def manifold_overlap_pallas(U1, U2, U1p, U2p, Mr, Ml, W) -> torch.Tensor:
    """Fused batched <psi(U1', U2')| Ml (x) W (x) Mr |psi(U1, U2)>: K6 for
    CUDA tensors, the plain version for CPU tensors."""
    if U1.device.type == "cpu":
        return manifold_overlap_batched(U1, U2, U1p, U2p, Mr, Ml, W)
    return _overlap_cuda(U1, U2, U1p, U2p, Mr, Ml, W)
