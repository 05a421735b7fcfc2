"""Energy objectives (counterpart of ``qmps_tpu.objectives.energy``).

Ported: the exact-environment energy of a D = 2 state unitary, batched
over any leading dimensions.  The circuit, two-site and joint-environment
energies wait (ROADMAP.md, item 19).
"""
from __future__ import annotations

import torch

from ..embed.unitaries import unitary_to_tensor
from ..mps.imps import merge
from ..mps.transfer import right_fixed_point


def _right_env(A: torch.Tensor) -> torch.Tensor:
    _, r = right_fixed_point(A, A)
    r = (r + r.mH) / 2
    return r / r.diagonal(dim1=-2, dim2=-1).sum(-1)[..., None, None]


def energy_exact_env(U: torch.Tensor, h) -> torch.Tensor:
    """<h> of the uMPS defined by state unitaries U (..., 4, 4), exact
    environment: U's isometry block is left-canonical, so the energy is
    one blocked-transfer contraction.  h[t, s] (..., 4, 4) takes its BRA
    index t on the conjugated tensor."""
    A = unitary_to_tensor(U)
    r = _right_env(A)
    A2 = merge(A, A)
    h = torch.as_tensor(h).to(A.device, A.dtype)
    return torch.einsum("...ts,...sij,...jk,...tik->...", h, A2, r, A2.conj()).real
