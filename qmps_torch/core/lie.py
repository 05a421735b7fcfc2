"""Lie-algebra parametrizations of unitaries (counterpart of
``qmps_tpu.core.lie``), batched over leading dimensions.

``su_generators`` and ``_first_column_generators`` are host numpy tables,
copied; ``SU``, ``U4`` and ``first_column_unitary`` run
``torch.linalg.matrix_exp`` in complex128 whatever the parameters' type.
The closed forms ``U2f``, ``U4_kak`` and ``U4_state`` are those of
new_tdvp/unitary_param.py:77-120.  Parameters (..., k) real give
(..., N, N) unitaries in the matching complex type on the parameters'
device.  The bond-dimension warm start (``extract_su_params``,
``embed_su_params``, ``grow_su_params``; scripts/bond_dimension.py:24-35)
is host numpy, as in the JAX package.
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from .gates import CNOT, SWAP, _angle, complex_type, rotations


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


# -- closed-form parametrizations (new_tdvp/unitary_param.py) ----------------


def U2f(a, b, c, d) -> torch.Tensor:
    """General U(2) with explicit phases (unitary_param.py:77-86)."""
    a, b, c, d = (_angle(x) for x in (a, b, c, d))
    ct = complex_type(a)

    def ph(x):
        return torch.exp(1j * x.to(ct))

    cos, sin = torch.cos(c / 2).to(ct), torch.sin(c / 2).to(ct)
    return torch.stack([
        torch.stack([ph(a - b / 2 - d / 2) * cos, -ph(a - b / 2 + d / 2) * sin], -1),
        torch.stack([ph(a + b / 2 - d / 2) * sin, ph(a + b / 2 + d / 2) * cos], -1),
    ], -2)


def _kron(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Kronecker product of (..., 2, 2) with (..., 2, 2) -> (..., 4, 4),
    broadcast over the leading dimensions (``torch.kron`` takes none: it
    would multiply the batch dimensions too)."""
    out = a[..., :, None, :, None] * b[..., None, :, None, :]
    return out.reshape(out.shape[:-4] + (4, 4))


def U4_kak(p) -> torch.Tensor:
    """19-param U(4), KAK-style: 4 local U(2)s, 3 CNOTs and 3 rotations
    between them (unitary_param.py:110-120); p (..., 19) -> (..., 4, 4)."""
    p = _angle(p)
    ct = complex_type(p)
    c0 = CNOT.to(p.device, ct)
    c1 = SWAP.to(p.device, ct) @ c0 @ SWAP.to(p.device, ct)  # control on qubit 1
    # the four U(2)s and the three rotations each in one batched call (the
    # sweeps build every brick of a wall forward and backward each step)
    u = U2f(*p[..., :16].reshape(p.shape[:-1] + (4, 4)).unbind(-1))  # (..., 4, 2, 2): u1 .. u4
    r = rotations(p[..., 16:], "yyz")
    eye = torch.eye(2, dtype=ct, device=p.device)
    pair = _kron(u[..., 0::2, :, :], u[..., 1::2, :, :])  # kron(u1, u2), kron(u3, u4)
    return (pair[..., 1, :, :] @ c0) @ _kron(r[..., 0, :, :], eye) @ (c1 @ _kron(r[..., 1, :, :], r[..., 2, :, :])) \
        @ (c0 @ pair[..., 0, :, :])


def U4_state(p) -> torch.Tensor:
    """Normalized 2-qubit state from 9 params (unitary_param.py:89-108;
    the reference's docstring says 7 but its code reads 9: at least 7 are
    taken and zero-padded)."""
    p = _angle(p).reshape(-1)
    p = torch.cat([p, torch.zeros(9, dtype=p.dtype, device=p.device)])[:9]
    ct = complex_type(p)
    S = torch.diag_embed(torch.stack([torch.cos(p[8]).to(ct), 1j * torch.sin(p[8]).to(ct)]))
    return (U2f(*p[0:4]) @ S @ U2f(*p[4:8])).reshape(4)


# -- warm-start embedding (host numpy) ----------------------------------------


def extract_su_params(U: np.ndarray) -> np.ndarray:
    """Project i log(U) onto the su(N) generator basis (xmps extractv
    analogue); host numpy, a dense eigendecomposition of the unitary."""
    U = np.asarray(U)
    N = U.shape[0]
    w, V = np.linalg.eig(U)
    phase = np.angle(np.linalg.det(U)) / N  # strip the global phase so log lands in su(N)
    w = w * np.exp(-1j * phase)
    H = -(V @ np.diag(np.log(w)) @ np.linalg.inv(V)) / 1j  # U = expm(-iH)
    H = (H + H.conj().T) / 2
    # the generators satisfy tr(G_a G_b) = 2 delta_ab
    return np.real(np.einsum("aij,ji->a", su_generators(N), H)) / 2.0


def embed_su_params(v: np.ndarray, eps: float = 4e-2) -> np.ndarray:
    """su(N) params -> su(2N) params for the D -> 2D warm start
    (scripts/bond_dimension.py:24-35, ``fixindices(insu2N(.))``): the new
    bond qubit enters as an identity factor, least significant, and the
    reference's uniform eps shift moves off singular points."""
    v = np.asarray(v)
    N = int(np.sqrt(len(v) + 1))
    U = SU(torch.from_numpy(v.astype(np.float64)), N).numpy()
    return extract_su_params(np.kron(U, np.eye(2))) + eps


@lru_cache(maxsize=None)
def _grow_su_map(N: int) -> np.ndarray:
    """(4N^2-1, N^2-1) matrix M with coeffs(kron(H, I2)) = M @ coeffs(H):
    kron(U, I2) = expm(-i kron(H, I2)) exactly, so the D -> 2D embedding
    is linear in the su(N) coefficients (no matrix log, no branch cut)."""
    K = np.einsum("aij,kl->aikjl", su_generators(N), np.eye(2)).reshape(N * N - 1, 2 * N, 2 * N)
    return np.real(np.einsum("bij,aji->ba", su_generators(2 * N), K)) / 2.0


def grow_su_params(vs: np.ndarray, eps: float = 4e-2) -> np.ndarray:
    """Batched D -> 2D warm-start embedding: (..., N^2-1) su(N) params ->
    (..., 4N^2-1) su(2N) params through ``_grow_su_map``, plus the
    reference's eps shift (the semantics of ``embed_su_params``)."""
    vs = np.asarray(vs)
    N = int(np.sqrt(vs.shape[-1] + 1))
    return vs @ _grow_su_map(N).T + eps
