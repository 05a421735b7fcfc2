"""Gen-2 brickwork circuit MPS (counterpart of ``qmps_tpu.circuits.brickwork``).

A D = 2 uniform MPS whose unit cell is two brickwork layers (U2 on even
bonds feeding U1 on odd bonds), new_tdvp/{ClassicalTDVPStripped,
BrickWallMPS}.py.  A 2-qubit gate U reshaped (2, 2, 2, 2) is
U[out1, out2, in1, in2], and every function is batched over leading
dimensions.

Each diagram is the JAX package's einsum network with its index numbers.
Where the JAX function reads one entry of an open leg ([0, 0, ...] of the
result), the port takes that entry of the operand before contracting:
``_col`` is a brick acting on |00>, ``_row`` a daggered brick read out on
<00|.  The networks are contracted pairwise, strictly in the order their
operands are listed (``_contract``), so the order is written down once and
every machine computes the same sequence whatever einsum path planner it
has; the order keeps each intermediate at 64 entries or fewer.
"""
from __future__ import annotations

import math

import torch

from ..core import lie
from ..core.linalg import _chirp
from ..embed.unitaries import environment_to_unitary
from ..mps.transfer import dominant_eigpair_cgauge
from .ir import apply_unitary


def _contract(*args) -> torch.Tensor:
    """``_contract(T0, idx0, T1, idx1, ..., out)``: contract a tensor
    network pairwise, left to right, each step keeping only the indices
    that a later operand or the output needs; leading dimensions broadcast
    as a batch."""
    *ops, out = args
    ts, ids = ops[0::2], [list(i) for i in ops[1::2]]
    acc, acc_ids = ts[0], ids[0]
    for k in range(1, len(ts)):
        later = set(out).union(*ids[k + 1:])
        keep = [i for i in dict.fromkeys(acc_ids + ids[k]) if i in later]
        acc = torch.einsum(acc, [..., *acc_ids], ts[k], [..., *ids[k]], [..., *keep])
        acc_ids = keep
    return torch.einsum(acc, [..., *acc_ids], [..., *out])


def _t(U: torch.Tensor) -> torch.Tensor:
    return U.reshape(U.shape[:-2] + (2, 2, 2, 2))


def _col(U: torch.Tensor) -> torch.Tensor:
    """A brick on |00>: (..., out1, out2)."""
    return _t(U)[..., 0, 0]


def _row(Ud: torch.Tensor) -> torch.Tensor:
    """A daggered brick read out on <00|: (..., in1, in2)."""
    return _t(Ud)[..., 0, 0, :, :]


def param_bricks(params: torch.Tensor):
    """22 params -> (U1, U2): U1 a full 15-param SU(4), U2 a 7-param
    first-column unitary (ClassicalTDVPStripped.py:146-166)."""
    return lie.U4(params[..., 7:]), lie.first_column_unitary(params[..., :7])


def _m2(a, b, c, d) -> torch.Tensor:
    """(..., 2, 2) [[a, b], [c, d]] from broadcastable complex tensors."""
    a, b, c, d = torch.broadcast_tensors(a, b, c, d)
    return torch.stack([torch.stack([a, b], -1), torch.stack([c, d], -1)], -2)


def env_M(params: torch.Tensor) -> torch.Tensor:
    """6-param 2x2 environment matrix ansatz M
    (ClassicalTDVPStripped.py:140-143): Z X Z D3 X Z products."""
    p = params.to(torch.promote_types(params.dtype, torch.complex64))
    a, b, c, d, e, f = (p[..., i] for i in range(6))
    zero, one = torch.zeros_like(a), torch.ones_like(a)

    def Zg(t):
        return _m2(one, zero, zero, torch.exp(1j * math.pi * t))

    def Xg(t):
        co, si = torch.cos(math.pi * t / 2), torch.sin(math.pi * t / 2)
        return _m2(co, -1j * si, -1j * si, co)

    def D3(t):
        return _m2(torch.cos(t), zero, zero, torch.sin(t))

    return Zg(b) @ Xg(c) @ Zg(d) @ D3(a) @ Xg(e) @ Zg(f)


def bw_state(U1: torch.Tensor, U2: torch.Tensor, l: int) -> torch.Tensor:
    """Dense 2l-qubit brickwork state: U2 layer on all cells, then U1 on the
    interior bonds (BrickWallMPS.py:75-87)."""
    n = 2 * l
    psi = torch.zeros(2**n, dtype=U1.dtype, device=U1.device)
    psi[0] = 1.0
    for c in range(l):
        psi = apply_unitary(psi, U2, (2 * c, 2 * c + 1), n)
    for c in range(l - 1):
        psi = apply_unitary(psi, U1, (2 * c + 1, 2 * c + 2), n)
    return psi


def bricks_to_tensor_left(U1: torch.Tensor, U2: torch.Tensor) -> torch.Tensor:
    """Left-leaning brick pair -> blocked MPS tensor A[(d d'), i, j]
    (BrickWallMPS.py:89-98) as (..., 2, 4, 2)."""
    A = torch.einsum("...ab,...cdbe->...acde", _col(U2), _t(U1))
    return A.reshape(A.shape[:-4] + (2, 4, 2))


def bricks_to_tensor_right(U1: torch.Tensor, U2: torch.Tensor) -> torch.Tensor:
    """Right-leaning brick pair -> blocked MPS tensor (BrickWallMPS.py:100-111)."""
    A = torch.einsum("...ab,...cdea->...bcde", _col(U2), _t(U1))
    return A.reshape(A.shape[:-4] + (2, 4, 2)).transpose(-1, -3)


def bricks_from_tensor(A: torch.Tensor):
    """QR and polar split of one (2, 2, 2) MPS tensor into a brick pair
    (U1, U2), the reference's ``Us_from_A``
    (new_tdvp/loschmidt_classical.py:93-141), differentiable: SVD polar
    and a QR first-column completion (``environment_to_unitary``) where
    the reference used scipy's polar and a null space.

    An approximate initializer, as in the reference: the blocked 1-site
    state does not lie in the left-leaning manifold in general (the polar
    step projects).  ``algorithms.brickwork_tdvp.compile_tensor_to_bricks``
    polishes it with gradients."""
    Bm = torch.einsum("sij,tjk->iskt", A, A).reshape(2, 8)  # rows: the left bond
    C, Dm = torch.linalg.qr(Bm)  # C (2, 2) unitary, Dm (2, 8)
    u, s, vh = torch.linalg.svd(Dm.reshape(2, 2, 2, 2).permute(1, 2, 0, 3).reshape(4, 4))
    U1 = u @ vh  # the polar unitary factor
    H = (vh.mH * s.to(vh.dtype)) @ vh  # the hermitian factor, absorbed into the column
    return U1, environment_to_unitary(torch.einsum("abcd,dc->ab", H.reshape(2, 2, 2, 2), C))


def right_env_map(U1, U2, U1d, U2d, M) -> torch.Tensor:
    """One application of the brickwork mixed transfer map to a 2x2 matrix M
    (RightEnvironment.circuit, ClassicalTDVPStripped.py:355-377)."""
    return _contract(
        _row(U2d), [10, 9], _t(U1d), [2, 10, 4, 5], M, [9, 8], _t(U1), [4, 5, 1, 3],
        _col(U2), [3, 8], [2, 1],
    )


def right_env_matrix(U1, U2, U1d, U2d) -> torch.Tensor:
    """The 4x4 matrix of the right transfer map
    (RightEnvironment.exact_environment_circuit,
    ClassicalTDVPStripped.py:399-422)."""
    m = _contract(
        _row(U2d), [8, 7], _t(U1d), [3, 8, 9, 10], _t(U1), [9, 10, 0, 11], _col(U2), [11, 6],
        [3, 0, 7, 6],
    )
    return m.reshape(m.shape[:-4] + (4, 4))


def left_env_matrix(U1, U2, U1d, U2d) -> torch.Tensor:
    """The 4x4 matrix of the left transfer map
    (LeftEnvironment.exact_environment_circuit,
    ClassicalTDVPStripped.py:331-339)."""
    m = _contract(
        _row(U2d), [7, 8], _t(U1d), [8, 5, 9, 10], _t(U1), [9, 10, 11, 2], _col(U2), [6, 11],
        [2, 5, 6, 7],
    )
    return m.reshape(m.shape[:-4] + (4, 4))


def _unit_eigpair(M: torch.Tensor):
    """Dominant (eta, unit v as 2x2) of (..., 4, 4) matrices, v in the
    c^T v = 1 phase gauge, with the implicit bordered-solve adjoint.

    The JAX package differentiates through the 40 squarings instead; there
    the eigenvector's phase carries 2^40 d(arg eta), which cancels in any
    phase-invariant cost only in exact arithmetic, so its float64 gradient
    of ``evolve_cost_exact_env`` carries amplified rounding (ROADMAP.md,
    "Faults in the port against the reference")."""
    eta, v = dominant_eigpair_cgauge(M, _chirp(4, M.dtype, M.device))
    v = v / torch.linalg.vector_norm(v, dim=-1, keepdim=True)
    return eta, v.reshape(v.shape[:-1] + (2, 2))


def exact_right_env(U1, U2, U1d, U2d):
    """Dominant (eta, r) of the right transfer map
    (ClassicalTDVPStripped.py:424-431), r unit-norm."""
    return _unit_eigpair(right_env_matrix(U1, U2, U1d, U2d))


def exact_left_env(U1, U2, U1d, U2d):
    return _unit_eigpair(left_env_matrix(U1, U2, U1d, U2d))


def env_from_M(M, U2, U2d) -> torch.Tensor:
    """A mid-bond environment matrix M -> the cell-boundary right
    environment, by the half-cell U2 contraction (the reference's
    find_env_from_M, new_tdvp/loschmidt_classical.py:318-336)."""
    return _contract(_row(U2d), [5, 7], M, [7, 6], _col(U2), [4, 6], [4, 5])


def manifold_overlap(U1, U2, U1d, U2d, Mr, Ml, W) -> torch.Tensor:
    """The 13-tensor TDVP overlap <psi(U')| Ml (x) W (x) Mr |psi(U)>
    (ManifoldOverlap.circuit, ClassicalTDVPStripped.py:239-275).

    Order: the ket side (the three U2 columns through the two U1s), the
    environments, W, then the bra side; no intermediate exceeds 64 entries
    (the JAX package leaves the order to its path planner)."""
    W8 = W.reshape(W.shape[:-2] + (2,) * 8)
    c2, r2 = _col(U2), _row(U2d)
    return _contract(
        c2, [12, 13], _t(U1), [18, 19, 13, 14], c2, [14, 15], _t(U1), [20, 21, 15, 16],
        c2, [16, 17], Ml, [26, 12], Mr, [31, 17], W8, [22, 23, 24, 25, 18, 19, 20, 21],
        _t(U1d), [27, 28, 22, 23], r2, [26, 27], _t(U1d), [29, 30, 24, 25], r2, [28, 29],
        r2, [30, 31], [],
    )


def expectation_2site(U1, U2, O) -> torch.Tensor:
    """<O> for a 2-qubit operator on the 4-qubit brickwork window
    (OverlapCalculator.qbt2_exp_val, ClassicalTDVPStripped.py:511-544)."""
    r2, c2 = _row(U2.mH), _col(U2)
    O4 = O.to(U1.dtype).reshape(O.shape[:-2] + (2, 2, 2, 2))
    return _contract(
        c2, [8, 16], r2, [8, 9], r2, [10, 11], _t(U1.mH), [9, 10, 12, 13], O4, [12, 13, 14, 15],
        _t(U1), [14, 15, 16, 17], c2, [17, 11], [],
    ).real


def expectation_4site(U1, U2, O) -> torch.Tensor:
    """<O> for a 4-qubit operator on the 6-qubit brickwork window
    (OverlapCalculator.qbt4_exp_val, ClassicalTDVPStripped.py:464-496)."""
    r2, c2, U1d = _row(U2.mH), _col(U2), _t(U1.mH)
    O8 = O.to(U1.dtype).reshape(O.shape[:-2] + (2,) * 8)
    return _contract(
        r2, [12, 13], U1d, [13, 14, 18, 19], r2, [14, 15], U1d, [15, 16, 20, 21], r2, [16, 17],
        O8, [18, 19, 20, 21, 22, 23, 24, 25], _t(U1), [22, 23, 26, 27], c2, [12, 26],
        _t(U1), [24, 25, 28, 29], c2, [27, 28], c2, [29, 17], [],
    ).real
