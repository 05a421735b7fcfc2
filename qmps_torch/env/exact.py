"""Exact environments from transfer-matrix fixed points (counterpart of
``qmps_tpu.env.exact``).

Reference: qmps/tools.py:176-186 (dense scipy eig + cholesky).  The fixed
point comes from the differentiable ``mps.transfer`` solvers, so an
environment sits inside autograd.
"""
from __future__ import annotations

import torch

from ..core.linalg import rotate_to_hermitian
from ..embed.unitaries import environment_to_unitary, unitary_to_tensor
from ..mps import transfer as tr
from ..mps.imps import _trace


def _env_C_from_tensor(A: torch.Tensor) -> torch.Tensor:
    """C with C C^dag = r, the right fixed point of A's transfer operator.
    The jitter is the JAX package's 1e-14 in float64; in float32, where
    1e-14 lies below the type's resolution, 32 eps (``mps.imps``'s rule)."""
    _, r = tr.right_fixed_point(A, A)
    r = (r + r.mH) / 2
    r = r / _trace(r)[..., None, None]
    eps = max(1e-14, 32 * torch.finfo(r.real.dtype).eps)
    return torch.linalg.cholesky(r + eps * torch.eye(r.shape[-1], dtype=r.dtype, device=r.device))


def get_env_exact_C(U: torch.Tensor) -> torch.Tensor:
    """The environment 'square root' C of a state unitary U."""
    return _env_C_from_tensor(unitary_to_tensor(U))


def get_env_exact(U: torch.Tensor) -> torch.Tensor:
    """State unitary U -> environment unitary V with V|0..0> = vec(C),
    rho_top = C C^dag = r (reference get_env_exact, qmps/tools.py:176-182)."""
    return environment_to_unitary(get_env_exact_C(U).reshape(-1))


def power_method_env(U: torch.Tensor, k: int, v0: torch.Tensor | None = None) -> torch.Tensor:
    """Power-method environment: the transfer operator applied k times to
    a start (I / D unless ``v0``), normalised each time, then rotated
    hermitian with unit trace (the PowerCircuit capability,
    qmps/represent.py:235-248, as a contraction instead of k stacked
    circuit copies)."""
    A = unitary_to_tensor(U)
    D = A.shape[-1]
    r = torch.eye(D, dtype=A.dtype, device=A.device) / D if v0 is None else v0
    for _ in range(k):
        r = tr.right_matvec(A, A, r)
        r = r / torch.linalg.matrix_norm(r)
    r = rotate_to_hermitian(r)
    return r / _trace(r)
