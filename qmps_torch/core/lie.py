"""Lie-algebra parametrizations of unitaries (counterpart of
``qmps_tpu.core.lie``), batched over leading dimensions.

Ported: ``su_generators`` and ``_first_column_generators`` (host numpy
tables, copied), ``SU``, ``U4`` and ``first_column_unitary`` through
``torch.linalg.matrix_exp``, evaluated in complex128 whatever the
parameters' type.  Parameters (..., k) real give (..., N, N) unitaries in
the matching complex type on the parameters' device.  The
closed forms (``U2f``, ``U4_kak``, ``U4_state``) and the embed / extract /
grow helpers wait (ROADMAP.md, item 2).
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from .gates import complex_type


@lru_cache(maxsize=None)
def su_generators(N: int) -> np.ndarray:
    """Generalized Gell-Mann basis of su(N), stacked (N^2-1, N, N): for
    each pair j<k (row-major) the symmetric then antisymmetric generator,
    then the N-1 diagonal generators."""
    gens = []
    for j in range(N):
        for k in range(j + 1, N):
            s = np.zeros((N, N), dtype=np.complex128)
            s[j, k] = s[k, j] = 1.0
            gens.append(s)
            a = np.zeros((N, N), dtype=np.complex128)
            a[j, k] = -1j
            a[k, j] = 1j
            gens.append(a)
    for l in range(1, N):
        d = np.zeros((N, N), dtype=np.complex128)
        d[:l, :l] = np.eye(l)
        d[l, l] = -l
        gens.append(np.sqrt(2.0 / (l * (l + 1))) * d)
    return np.stack(gens)


def _expm_i(v: torch.Tensor, G: np.ndarray) -> torch.Tensor:
    """expm(-i sum_k v[..., k] G[k]) for real v (..., k), evaluated in
    complex128 and rounded to v's complex type: torch's complex64
    matrix_exp (scaling and squaring) loses ~1e-5 at generator entries of
    tens (tests/test_torch_lie.py prints it), enough to stall a float32
    L-BFGS ground state."""
    v = torch.as_tensor(v)
    Gt = torch.from_numpy(G).to(v.device)
    H = torch.einsum("...k,kij->...ij", v.to(Gt.dtype), Gt)
    return torch.linalg.matrix_exp(-1j * H).to(complex_type(v))


def SU(v, N: int) -> torch.Tensor:
    """expm(-i v . G) over the su(N) basis; v has N^2-1 real entries."""
    return _expm_i(v, su_generators(N))


def U4(v) -> torch.Tensor:
    """15-parameter SU(4) (xmps.spin.U4 analogue)."""
    return SU(v, 4)


@lru_cache(maxsize=None)
def _first_column_generators() -> np.ndarray:
    """7 su(4) generators whose exponential sweeps out all states e^{iH}|00>:
    the pair generators touching index 0 and one diagonal generator with
    weight on index 0 (ClassicalTDVPStripped.py:30-36)."""
    gens = []
    for k in range(1, 4):
        s = np.zeros((4, 4), dtype=np.complex128)
        s[0, k] = s[k, 0] = 1.0
        gens.append(s)
        a = np.zeros((4, 4), dtype=np.complex128)
        a[0, k] = -1j
        a[k, 0] = 1j
        gens.append(a)
    d = np.diag([3.0, -1.0, -1.0, -1.0]) / np.sqrt(6.0)
    gens.append(d.astype(np.complex128))
    return np.stack(gens)


def first_column_unitary(p) -> torch.Tensor:
    """7-param 2-qubit unitary; U|00> covers all normalized 2-qubit states."""
    return _expm_i(p, _first_column_generators())
