"""Energy objectives (counterpart of ``qmps_tpu.objectives.energy``).

The exact-environment energy of a state unitary, batched over any leading
dimensions (the fast path: one blocked-transfer contraction); the
reference's circuit evaluation State(U, V, 2) (qmps/ground_state.py:
159-167), the two-site unit cell's energy and the joint state and
environment objective with its purity penalty, for the optimizer classes
and the noisy and sampled parity checks.
"""
from __future__ import annotations

import torch

from ..circuits.ir import circuit_state
from ..core.paulis import kron_all
from ..embed.unitaries import unitary_to_tensor
from ..env.exact import get_env_exact
from ..env.variational import reduced_density_matrix, state_circuit_psi
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


def _bond_h(h, D: int, dtype, device) -> torch.Tensor:
    """I_D (x) h (x) I_D in ``dtype`` on ``device``."""
    eye = torch.eye(D, dtype=dtype, device=device)
    return kron_all([eye, torch.as_tensor(h).to(device, dtype), eye])


def energy_circuit(U: torch.Tensor, h, V: torch.Tensor | None = None) -> torch.Tensor:
    """The reference's circuit evaluation: psi = State(U, V, 2)|0>, E =
    <psi| I_D (x) h (x) I_D |psi> (qmps/ground_state.py:159-167); V is the
    exact environment unless given."""
    if V is None:
        V = get_env_exact(U)
    psi = state_circuit_psi(U, V, 2)
    return (psi.conj() @ (_bond_h(h, U.shape[-1] // 2, psi.dtype, psi.device) @ psi)).real


def energy_two_site(U1: torch.Tensor, U2: torch.Tensor, h) -> torch.Tensor:
    """Energy of the 2-site unit cell, averaged over its two bond types
    (NonSparseFullTwoSiteEnergyOptimizer, qmps/ground_state.py:271-331)."""
    A1, A2 = unitary_to_tensor(U1), unitary_to_tensor(U2)

    def bond_energy(Aa, Ab):
        A12 = merge(Aa, Ab)
        hh = torch.as_tensor(h).to(A12.device, A12.dtype)
        return torch.einsum("ts,sij,jk,tik->", hh, A12, _right_env(A12), A12.conj()).real

    return (bond_energy(A1, A2) + bond_energy(A2, A1)) / 2


def energy_joint_env_purity(params: torch.Tensor, h, k: float = 1.0, gate=None) -> torch.Tensor:
    """The joint (state, environment) objective with the swap-test purity
    penalty (SparseFullEnergyOptimizer.objective_function_opt_environment,
    qmps/ground_state.py:170-228):

        E + k (Tr rho_u^2 + Tr rho_v^2 - 2 Tr rho_u rho_v)

    rho_u the bond density matrix of the state column, rho_v that of the
    environment; the penalty vanishes iff the environment is the state's
    fixed point.  params = [p_state, p_env] (15 + 15 by default, ``gate``
    the full15 circuit)."""
    from ..circuits.ansatze import shallow_full_state

    gate = shallow_full_state if gate is None else gate
    half = params.shape[-1] // 2
    Uu, Uv = gate(params[:half]), gate(params[half:])
    # the energy circuit: V on qubits (2, 3), U on (1, 2), U on (0, 1)
    psi_e = circuit_state([(Uv, (2, 3)), (Uu, (1, 2)), (Uu, (0, 1))], 4)
    energy = (psi_e.conj() @ (_bond_h(h, 2, psi_e.dtype, psi_e.device) @ psi_e)).real
    # the purities from the reduced density matrices (the reference's
    # swap-test circuit values)
    rho_v = reduced_density_matrix(circuit_state([(Uv, (0, 1))], 2), [0], 2)
    rho_u = reduced_density_matrix(circuit_state([(Uv, (1, 2)), (Uu, (0, 1))], 3), [0], 3)

    def tr(a, b):
        return (a @ b).diagonal().sum().real

    return energy + k * tr(rho_u, rho_u) + k * tr(rho_v, rho_v) - 2 * k * tr(rho_u, rho_v)
