"""Unitary -> MPS tensor (counterpart of ``qmps_tpu.embed.unitaries``).

Ported: ``unitary_to_tensor``.  ``tensor_to_unitary`` and the environment
embeddings need ``unitary_completion`` and wait (ROADMAP.md, item 3).
"""
from __future__ import annotations

import torch


def unitary_to_tensor(U: torch.Tensor) -> torch.Tensor:
    """(..., 2^n, 2^n) unitary -> (..., 2, D, D) MPS tensor, D = 2^(n-1):
    the first input qubit set to |0>, A[s, i, j] = U[(i s), j]
    (qmps/tools.py:151-154)."""
    D = U.shape[-1] // 2
    return U[..., :, :D].reshape(U.shape[:-2] + (D, 2, D)).transpose(-3, -2)
