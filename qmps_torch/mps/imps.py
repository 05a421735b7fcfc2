"""Uniform MPS helpers (counterpart of ``qmps_tpu.mps.imps``).

Ported: ``merge``.  The ``iMPS`` class and the canonical forms wait
(ROADMAP.md, item 4).  A tensor A has shape (..., d, D, D) =
(physical, left, right).
"""
from __future__ import annotations

import torch


def merge(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Block two site tensors into one (..., d1 d2, D, D) tensor
    (qmps/time_evolve_tools.py:20-23)."""
    AB = torch.einsum("...sik,...tkj->...stij", A, B)
    return AB.reshape(AB.shape[:-4] + (A.shape[-3] * B.shape[-3], A.shape[-2], B.shape[-1]))
