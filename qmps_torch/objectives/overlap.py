"""TDVP overlap objectives (counterpart of ``qmps_tpu.objectives.overlap``).

The canonical TDVP cost (qmps/new_time_evolve.py:193-221): given the
current left-canonical tensor A and the Trotter gate W = exp(-i h 2dt),
score a candidate tensor B by the dominant eigenvalue x of the mixed
transfer operator E = Map(W (A (x) A), B (x) B), as -|x|.

Ported: the dense objective and the batched ``tdvp_objective_pallas``
dispatch, which at D = 2 runs the fused kernels K4/K5 and at D >= 3 the
batched eigenvalue over K7/K8.  The Hadamard-test circuit forms and the
variational overlap wait (ROADMAP.md, item 11).
"""
from __future__ import annotations

import torch

from ..kernels.pallas_power import dominant_eigval_batched
from ..kernels.tdvp_fused import tdvp_objective_fused
from ..mps import transfer as tr
from ..mps.imps import merge


def mixed_transfer_with_gate(A: torch.Tensor, B: torch.Tensor, W: torch.Tensor):
    """(W (A (x) A), B (x) B): the blocked two-site tensors of the mixed
    transfer operator, with the Trotter gate applied to the ket."""
    AA = merge(A, A)
    WAA = torch.einsum("...st,...tij->...sij", W.to(A.device, A.dtype), AA)
    return WAA, merge(B, B)


def tdvp_objective(A: torch.Tensor, B: torch.Tensor, W: torch.Tensor) -> torch.Tensor:
    """-|x| (batched over leading dimensions); the gradient is the rank-1
    implicit adjoint of ``dominant_eigval_dense``."""
    WAA, BB = mixed_transfer_with_gate(A, B, W)
    return -tr.dominant_eigval_dense(tr.transfer_dense(WAA, BB)).abs()


def tdvp_objective_pallas(
    As: torch.Tensor, Bs: torch.Tensor, W: torch.Tensor, iters: int = 48
) -> torch.Tensor:
    """Batched fast TDVP objective: (B, 2, D, D) x 2 and W, one (4, 4)
    gate or a (B, 4, 4) batch -> (B,) of -|x|.

    At D = 2 it is the fused objective (kernels/tdvp_fused.py: K4 forward,
    K5 backward on CUDA).  At D >= 3 the D^2 x D^2 mixed transfer matrices
    are built batched in PyTorch and their dominant eigenvalue taken by
    ``dominant_eigval_batched`` (on CUDA one launch of K7 for D = 3, 4 or
    K8 above; the backward is a rank-1 product with no launch).  Matches
    the batched dense ``tdvp_objective`` to solver precision."""
    if As.dim() != 4 or As.shape[1] != 2:
        raise ValueError(f"As must be batched (B, 2, D, D) MPS tensors, got {tuple(As.shape)}")
    if tuple(W.shape[-2:]) != (4, 4):
        raise ValueError(f"W must be a 2-site (4, 4) gate (optionally batched), got {tuple(W.shape)}")
    if As.shape[-1] == 2:
        return tdvp_objective_fused(As, Bs, W, iters)
    WAA, BB = mixed_transfer_with_gate(As, Bs, W)  # a (4, 4) W broadcasts over the batch
    return -dominant_eigval_batched(tr.transfer_dense(WAA, BB), iters).abs()
