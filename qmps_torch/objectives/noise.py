"""Depolarizing-noise circuit semantics, the density-matrix path
(counterpart of ``qmps_tpu.objectives.noise``).

The reference inserts a ConstantQubitNoiseModel(depolarize(p)) channel
after every circuit moment (qmps/ground_state.py:337-480, scripts/
loschmidt.py:241-318): after each gate every qubit passes through

    rho -> (1 - p) rho + (p/3)(X rho X + Y rho Y + Z rho Z).

The JAX package applies this as 3n gate conjugations a moment.  Here rho
is kept with each qubit's (ket, bra) pair as one site of dimension 4, and
the channel on one qubit is the fixed 4 x 4 superoperator

    S(p) = (1 - p) I4 + (p/3)(X (x) X* + Y (x) Y* + Z (x) Z*),

applied as one batched product a qubit (``circuits.ir.apply_on_every_site``);
a gate is U (x) U* on its qubits' pairs, one contraction.  Everything is
differentiable in the parameters and in p, and batched over leading
dimensions: a (L,) tensor p gives L noise levels, gates may carry the same
leading dimensions.
"""
from __future__ import annotations

from typing import Iterable, Sequence, Tuple

import torch

from ..circuits.ir import _LETTERS, apply_on_every_site, apply_unitary, n_qubits
from ..core.gates import complex_type
from ..core.paulis import X, Y, Z
from ..mps import transfer as tr
from .energy import _bond_h
from .overlap import bell_tdvp_ops, mixed_transfer_with_gate

Op = Tuple[torch.Tensor, Sequence[int]]

#: sum over P of P (x) P*, on the pair (ket, bra) of one qubit
_PAULI_PAIRS = sum(torch.kron(P, P.conj()) for P in (X, Y, Z))


def depolarizing_superop(p, dtype=torch.complex128, device=None) -> torch.Tensor:
    """S(p) (..., 4, 4) of the one-qubit depolarizing channel on the pair
    index 2 ket + bra, for p of any shape (...) (a number or a real tensor,
    differentiable)."""
    p = (p if isinstance(p, torch.Tensor) else torch.tensor(p, dtype=torch.float64)).to(device, dtype)[..., None, None]
    eye = torch.eye(4, dtype=dtype, device=device)
    return (1 - p) * eye + (p / 3) * _PAULI_PAIRS.to(device, dtype)


def _superop(U: torch.Tensor) -> torch.Tensor:
    """(..., 2^k, 2^k) gate -> (..., 4^k, 4^k) U (x) U* on the pairs of its
    qubits: G[(a1 a1', .. ak ak'), (b1 b1', ..)] = U[a, b] U*[a', b']."""
    k = n_qubits(U)
    Ut = U.reshape(U.shape[:-2] + (2,) * (2 * k))
    a, b, c, e = (_LETTERS[i * k:(i + 1) * k] for i in range(4))
    pairs = "".join(x + y for x, y in zip(a, c)) + "".join(x + y for x, y in zip(b, e))
    G = torch.einsum(f"...{a}{b},...{c}{e}->...{pairs}", Ut, Ut.conj())
    return G.reshape(U.shape[:-2] + (4**k, 4**k))


def _to_pairs(rho: torch.Tensor, n: int) -> torch.Tensor:
    """(..., 2^n, 2^n) -> (..., 4^n), site q the pair (ket_q, bra_q)."""
    lead = rho.shape[:-2]
    t = rho.reshape(lead + (2,) * (2 * n))
    k = len(lead)
    order = [i for q in range(n) for i in (k + q, k + n + q)]
    return t.permute(list(range(k)) + order).reshape(lead + (4**n,))


def _from_pairs(x: torch.Tensor, n: int) -> torch.Tensor:
    """The inverse of ``_to_pairs``."""
    lead = x.shape[:-1]
    t = x.reshape(lead + (2,) * (2 * n))
    k = len(lead)
    order = [k + 2 * q for q in range(n)] + [k + 2 * q + 1 for q in range(n)]
    return t.permute(list(range(k)) + order).reshape(lead + (2**n, 2**n))


def depolarize_qubit(rho: torch.Tensor, q: int, n: int, p) -> torch.Tensor:
    """The one-qubit depolarizing channel on qubit q of (..., 2^n, 2^n)
    density matrices: S(p) on the pair (ket_q, bra_q), as the circuits
    apply it."""
    S = depolarizing_superop(p, rho.dtype, rho.device)
    return _from_pairs(apply_unitary(_to_pairs(rho, n), S, (q,), n, d=4), n)


def _noisy_pairs(ops: Iterable[Op], n: int, p, rho0=None, dtype=None, device=None) -> torch.Tensor:
    ops = list(ops)
    first = rho0 if rho0 is not None else ops[0][0]
    dtype = dtype or complex_type(first)
    device = device or first.device
    if rho0 is None:
        x = torch.zeros(4**n, dtype=dtype, device=device)
        x[0] = 1.0
    else:
        x = _to_pairs(rho0.to(device, dtype), n)
    S = depolarizing_superop(p, dtype, device)
    for U, wires in ops:
        # a constant gate's superoperator is built where the gate lies (the
        # host), then moved
        x = apply_unitary(x, _superop(U).to(device, dtype), wires, n, d=4)
        x = apply_on_every_site(x, S, n, d=4)
    return x


def noisy_circuit_rho(ops: Iterable[Op], n: int, p, rho0=None, dtype=None, device=None) -> torch.Tensor:
    """|0..0><0..0| (or rho0) through the circuit, every qubit depolarized
    after each gate (cirq's noisy_moment semantics, one gate a moment).
    Returns (..., 2^n, 2^n); the type and device are ``rho0``'s, else the
    first gate's, unless given."""
    return _from_pairs(_noisy_pairs(ops, n, p, rho0, dtype, device), n)


def _energy_ops(state_ops: Sequence[Op], V: torch.Tensor):
    """V at the bottom, two copies of the state circuit walking up."""
    kv = n_qubits(V)
    ops = [(V, tuple(range(2, 2 + kv)))]
    ops += [(U, tuple(w + 1 for w in wires)) for U, wires in state_ops]
    return ops + list(state_ops), 2 + kv, 2 ** (kv // 2)


def noisy_energy(state_ops: Sequence[Op], n_state: int, V: torch.Tensor, h, p) -> torch.Tensor:
    """Noisy State(U, V, 2) energy (NoisySparseFullEnergyOptimizer,
    qmps/ground_state.py:453-477): V at the bottom, two copies of the
    elementary-gate state circuit walking up, depolarization after every
    gate, E = Tr[rho (I_D (x) h (x) I_D)] in V's type and device."""
    ops, n, D = _energy_ops(state_ops, V)
    rho = noisy_circuit_rho(ops, n, p, dtype=V.dtype, device=V.device)
    H = _bond_h(h, D, V.dtype, V.device)
    return (rho * H.mT).sum((-2, -1)).real


def noisy_tdvp_amplitude(A: torch.Tensor, B: torch.Tensor, W: torch.Tensor, r: torch.Tensor, p) -> torch.Tensor:
    """P(|0...0>) = rho[0, 0] of the noisy 6-qubit Bell-form TDVP circuit
    (scripts/loschmidt.py:241-277 noisy_obj), in A's type and device."""
    x = _noisy_pairs(bell_tdvp_ops(A, B, W, r), 6, p, dtype=A.dtype, device=A.device)
    return x[..., 0].real


def _fidelity_cost(p0: torch.Tensor) -> torch.Tensor:
    return -torch.sqrt(2.0 * torch.sqrt(p0.clamp(min=0.0)))


def noisy_tdvp_objective(A: torch.Tensor, B: torch.Tensor, W: torch.Tensor, p) -> torch.Tensor:
    """-sqrt(2 sqrt(P0)), the noisy Loschmidt TDVP cost
    (scripts/loschmidt.py:276-277 up to the monotone sqrt), r the mixed
    fixed point of E = Map(W (A x A), B x B)."""
    WAA, BB = mixed_transfer_with_gate(A, B, W)
    _, r = tr.right_fixed_point(WAA, BB)
    return _fidelity_cost(noisy_tdvp_amplitude(A, B, W, r, p))


def noisy_sampled_tdvp_objective(A, B, W, p, generator: torch.Generator, shots: int = 5000) -> torch.Tensor:
    """Noise and finite shots (scripts/loschmidt.py:279-318
    noisy_sampled_obj): P(|0...0>) of the noisy circuit estimated from
    ``shots`` measurements drawn from ``generator`` (on the state's
    device), then -sqrt(2 sqrt(p0_hat))."""
    from .sampling import sampled_noisy_p0

    WAA, BB = mixed_transfer_with_gate(A, B, W)
    _, r = tr.right_fixed_point(WAA, BB)
    rho00 = noisy_tdvp_amplitude(A, B, W, r, p)
    return _fidelity_cost(sampled_noisy_p0(generator, rho00.reshape(1, 1), shots))
