"""Batched brickwork overlap in flat form (counterpart of
``qmps_tpu.kernels.brickwork_fast``): the plain PyTorch version of K6.

The 13-operand overlap network (ManifoldOverlap.circuit) as a short
pipeline of batched products: (B, 16, 16) kron blocks applied to
(B, 2, 16, 2) state slabs.  Layout: 64 = (q0)(q1 q2 q3 q4)(q5); the U2
layer partitions as (q0 q1)(q2 q3)(q4 q5), the U1 layer and the
Ml (x) W (x) Mr center as (q0)(q1..q4)(q5).
"""
from __future__ import annotations

import torch


def _kron_b(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Batched Kronecker product: (B, m, m) x (B, n, n) -> (B, mn, mn)."""
    b, m, _ = A.shape
    n = B.shape[-1]
    return torch.einsum("bij,bkl->bikjl", A, B).reshape(b, m * n, m * n)


def manifold_overlap_batched(U1, U2, U1p, U2p, Mr, Ml, W) -> torch.Tensor:
    """<psi(U1p, U2p)| Ml (x) W (x) Mr |psi(U1, U2)> for a batch of brick
    pairs (the mcircuit form, ClassicalTDVPStripped.py:277-283).

    U1, U2, U1p, U2p: (B, 4, 4) unitaries; Mr, Ml: (B, 2, 2); W: (16, 16).
    Returns (B,) complex overlaps.
    """
    Bn = U1.shape[0]
    c2 = U2[:, :, 0]  # (B, 4): the U2 layer acting on |00>
    v = torch.einsum("bi,bj,bk->bijk", c2, c2, c2).reshape(Bn, 2, 16, 2)
    v = torch.einsum("bij,bajc->baic", _kron_b(U1, U1), v)
    v = torch.einsum("ij,bajc->baic", W, v)
    v = torch.einsum("bxa,baic->bxic", Ml, v)
    v = torch.einsum("byc,baic->baiy", Mr, v)
    v = torch.einsum("bji,bajc->baic", _kron_b(U1p, U1p).conj(), v)  # apply Kp^dag
    r2 = U2p[:, :, 0].conj()  # row 0 of U2p^dag, three-fold
    return torch.einsum("bi,bj,bk,bijk->b", r2, r2, r2, v.reshape(Bn, 4, 4, 4))
