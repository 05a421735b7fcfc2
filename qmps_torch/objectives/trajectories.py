"""Monte-Carlo trajectory unraveling of the depolarizing channel
(counterpart of ``qmps_tpu.objectives.trajectories``).

The reference's noisy optimizers simulate either the exact density matrix
or stochastic noise trajectories (the two cirq simulator modes behind
qmps/ground_state.py:337-418).  Here the channel of objectives/noise.py is
unraveled into pure-state trajectories: after every gate each qubit
receives

    I  with prob 1 - p,     X, Y or Z  each with prob p/3,

which reproduces rho -> (1-p) rho + (p/3)(X rho X + Y rho Y + Z rho Z)
in expectation, at 2^n a trajectory.  The trajectories are one batch
dimension, the last before the state's: every gate is one batched
contraction for all of them.  Each (moment, qubit) draws a uniform u; its
Pauli is a gather from the stacked (I, X, Y, Z) at the bin of u among the
edges 1 - p, 1 - 2p/3, 1 - p/3, with no branch.  Uniforms come from a
``torch.Generator`` (a CPU generator, seed 0, if None), drawn in float64
on its device, as one (..., n_traj, moments, n) tensor (``_uniforms``).
Gates and p may carry leading batch dimensions (noise levels); they come
before the trajectories' axis.
"""
from __future__ import annotations

from typing import Iterable, Sequence, Tuple

import torch

from ..circuits.ir import apply_on_every_site, apply_unitary
from ..core.gates import complex_type
from ..core.paulis import I2, X, Y, Z
from ..mps import transfer as tr
from .energy import _bond_h
from .noise import _energy_ops, _fidelity_cost
from .overlap import bell_tdvp_ops, mixed_transfer_with_gate

Op = Tuple[torch.Tensor, Sequence[int]]

_PAULI_STACK = torch.stack([I2, X, Y, Z])


def _uniforms(generator: torch.Generator | None, shape) -> torch.Tensor:
    """Uniforms in [0, 1) of ``shape``, float64, on the generator's device."""
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    return torch.rand(shape, generator=generator, dtype=torch.float64, device=generator.device)


def _stochastic_paulis(u: torch.Tensor, p, dtype=torch.complex128) -> torch.Tensor:
    """(..., n) uniforms -> (..., n, 2, 2) gates: I if u < 1 - p, else X, Y
    or Z by equal thirds of [1 - p, 1).  p broadcasts against u."""
    p = p if isinstance(p, torch.Tensor) else torch.tensor(p, dtype=torch.float64)
    p = p.to(u.device, u.dtype)
    k = (u >= 1.0 - p).long() + (u >= 1.0 - 2.0 * p / 3.0).long() + (u >= 1.0 - p / 3.0).long()
    return _PAULI_STACK.to(u.device, dtype)[k]


def _trajectory_states(ops: Iterable[Op], n: int, p, us: torch.Tensor, psi0=None, dtype=None,
                       device=None) -> torch.Tensor:
    """The trajectories of the noisy circuit from the uniforms ``us``
    (..., n_traj, moments, n): |0..0> (or psi0) through the gates, after
    each gate one sampled Pauli a qubit.  Returns (..., n_traj, 2^n); the
    type and device are the first gate's unless given."""
    ops = list(ops)
    first = ops[0][0]
    dtype = dtype or complex_type(first)
    device = device or first.device
    us = us.to(device)
    if psi0 is None:
        psi = torch.zeros(2**n, dtype=dtype, device=device)
        psi[0] = 1.0
    else:
        psi = psi0.to(device, dtype)
    # p (...) against the uniforms (..., n_traj, n)
    p = p if isinstance(p, torch.Tensor) else torch.tensor(p, dtype=torch.float64)
    p = p.to(device)[..., None, None]
    for m, (U, wires) in enumerate(ops):
        psi = apply_unitary(psi, U.to(device, dtype)[..., None, :, :], wires, n)
        paulis = _stochastic_paulis(us[..., m, :], p, dtype)
        psi = apply_on_every_site(psi, list(paulis.unbind(-3)), n)
    return psi


def trajectory_circuit_state(ops: Iterable[Op], n: int, p, generator: torch.Generator | None = None,
                             psi0=None) -> torch.Tensor:
    """One stochastic trajectory of the noisy circuit, (..., 2^n)."""
    ops = list(ops)
    return _trajectory_states(ops, n, p, _uniforms(generator, (1, len(ops), n)), psi0)[..., 0, :]


def trajectory_rho_estimate(ops: Sequence[Op], n: int, p, generator: torch.Generator | None = None,
                            n_traj: int = 512) -> torch.Tensor:
    """The mean of |psi><psi| over ``n_traj`` trajectories, an unbiased
    estimator of ``noise.noisy_circuit_rho``."""
    ops = list(ops)
    psi = _trajectory_states(ops, n, p, _uniforms(generator, (n_traj, len(ops), n)))
    return torch.einsum("...ti,...tj->...ij", psi, psi.conj()) / n_traj


def trajectory_energy(state_ops: Sequence[Op], n_state: int, V: torch.Tensor, h, p,
                      generator: torch.Generator | None = None, n_traj: int = 512) -> torch.Tensor:
    """The trajectory estimate of ``noise.noisy_energy``: the same circuit
    and channel, E = mean over trajectories of <psi| I_D (x) h (x) I_D
    |psi>, in V's type and device."""
    ops, n, _ = _energy_ops(state_ops, V)
    return _trajectory_energy_from(state_ops, V, h, p, _uniforms(generator, (n_traj, len(ops), n)))


def _trajectory_energy_from(state_ops: Sequence[Op], V: torch.Tensor, h, p, us: torch.Tensor) -> torch.Tensor:
    """``trajectory_energy`` from the uniforms ``us`` (n_traj, moments, n)."""
    ops, n, D = _energy_ops(state_ops, V)
    psi = _trajectory_states(ops, n, p, us, dtype=V.dtype, device=V.device)
    H = _bond_h(h, D, V.dtype, V.device)
    return (psi.conj() * (psi @ H.mT)).sum(-1).real.mean(-1)


def trajectory_tdvp_p0(A: torch.Tensor, B: torch.Tensor, W: torch.Tensor, r: torch.Tensor, p,
                       generator: torch.Generator | None = None, n_traj: int = 512) -> torch.Tensor:
    """The trajectory estimate of ``noise.noisy_tdvp_amplitude``: the mean
    of |<0...0|psi>|^2 over trajectories of the 6-qubit Bell-form circuit.
    A, B, W, r and p may carry leading batch dimensions."""
    ops = bell_tdvp_ops(A, B, W, r)
    batch = torch.broadcast_shapes(A.shape[:-3], B.shape[:-3], W.shape[:-2], r.shape[:-2], torch.as_tensor(p).shape)
    psi = _trajectory_states(ops, 6, p, _uniforms(generator, batch + (n_traj, len(ops), 6)), dtype=A.dtype,
                             device=A.device)
    return psi[..., 0].abs().square().mean(-1)


def trajectory_tdvp_objective(A, B, W, p, generator: torch.Generator | None = None,
                              n_traj: int = 512) -> torch.Tensor:
    """-sqrt(2 sqrt(P0)) with P0 from trajectories, the Monte-Carlo face of
    ``noise.noisy_tdvp_objective``."""
    WAA, BB = mixed_transfer_with_gate(A, B, W)
    _, r = tr.right_fixed_point(WAA, BB)
    return _fidelity_cost(trajectory_tdvp_p0(A, B, W, r, p, generator, n_traj))
