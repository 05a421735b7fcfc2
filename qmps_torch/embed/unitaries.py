"""Tensor <-> unitary and environment <-> unitary embeddings (counterpart of
``qmps_tpu.embed.unitaries``):

- ``tensor_to_unitary`` / ``unitary_to_tensor``   (qmps/tools.py:123-154)
- ``environment_to_unitary`` / ``_from_unitary``  (qmps/tools.py:97-120)
- ``put_env_on_left_site`` / ``_right_site`` and their inverses
  (qmps/time_evolve_tools.py:38-74)

A left-canonical MPS tensor A (d, D, D) embeds as the isometry
iso[(i, s), j] = A[s, i, j], completed to a unitary whose first D columns
are iso (``core.linalg.unitary_completion``, the same completion as the JAX
package's).  ``tensor_to_unitary``, ``unitary_to_tensor`` and the
``put_env_on_*`` embeddings are batched over leading dimensions; the others
take one tensor, vector or matrix.
"""
from __future__ import annotations

import torch

from ..core.gates import SWAP
from ..core.linalg import row_completion, unitary_completion


def tensor_to_unitary(A: torch.Tensor) -> torch.Tensor:
    """Left-canonical (..., d, D, D) tensors -> (..., d D, d D) unitaries
    whose first D columns are the isometry (qmps/tools.py:123-148)."""
    d, D, _ = A.shape[-3:]
    return unitary_completion(A.transpose(-3, -2).reshape(A.shape[:-3] + (D * d, D)))


def unitary_to_tensor(U: torch.Tensor) -> torch.Tensor:
    """(..., 2^n, 2^n) unitary -> (..., 2, D, D) MPS tensor, D = 2^(n-1):
    the first input qubit set to |0>, A[s, i, j] = U[(i s), j]
    (qmps/tools.py:151-154)."""
    D = U.shape[-1] // 2
    return U[..., :, :D].reshape(U.shape[:-2] + (D, 2, D)).transpose(-3, -2)


def environment_to_unitary(v: torch.Tensor) -> torch.Tensor:
    """Vector -> unitary whose first column is v/|v| (qmps/tools.py:97-108):
    V|0..0> prepares the environment's purification."""
    v = v.reshape(-1)
    return unitary_completion((v / torch.linalg.vector_norm(v))[:, None])


def environment_from_unitary(u: torch.Tensor) -> torch.Tensor:
    """The first column of u as a (2, 2) matrix C with rho = C C^dag
    (qmps/tools.py:111-120)."""
    return u[:, 0].reshape(2, 2)


def _rows_over_norm(r0, r1, q: torch.Tensor):
    n = torch.linalg.matrix_norm(q)
    rows = torch.stack([torch.stack(r0, -1), torch.stack(r1, -1)], -2)
    return rows / n[..., None, None], n


def _entries(q: torch.Tensor):
    """q (..., 2, 2) -> its entries q00, q01, q10, q11, each (...,)."""
    return q.reshape(q.shape[:-2] + (4,)).unbind(-1)


def put_env_on_left_site(q: torch.Tensor, ret_n: bool = False):
    """Embed (..., 2, 2) matrices q as 2-qubit unitaries from which the
    Bell-pair circuit reads q_ij / |q|_F (qmps/time_evolve_tools.py:38-53).
    Row 0, the only row the post-selected circuits address, is the
    reference's; the other rows are a differentiable QR completion."""
    a, b, c, d = _entries(q.mT)
    guess, n = _rows_over_norm([a, c.conj(), b, d.conj()], [c, -a.conj(), d, -b.conj()], q)
    A = SWAP.to(q.device, q.dtype) @ row_completion(guess)
    return (A, n) if ret_n else A


def get_env_off_left_site(A: torch.Tensor) -> torch.Tensor:
    """Inverse of ``put_env_on_left_site`` (qmps/time_evolve_tools.py:55-57):
    the entries A[(i, 0), (j, 0)], transposed."""
    return A.reshape(2, 2, 2, 2)[:, 0, :, 0].T


def put_env_on_right_site(q: torch.Tensor, ret_n: bool = False):
    """The mirror embedding, for the left environment
    (qmps/time_evolve_tools.py:59-70)."""
    a, b, c, d = _entries(q)
    guess, n = _rows_over_norm([a, b, d.conj(), -c.conj()], [c, d, -b.conj(), a.conj()], q)
    A = row_completion(guess)
    return (A, n) if ret_n else A


def get_env_off_right_site(A: torch.Tensor) -> torch.Tensor:
    """Inverse of ``put_env_on_right_site`` (qmps/time_evolve_tools.py:72-74):
    the entries A[(0, i), (0, j)]."""
    return A.reshape(2, 2, 2, 2)[0, :, 0, :]
