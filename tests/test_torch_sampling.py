"""qmps_torch's finite-shot measurements (objectives.sampling,
Hamiltonian.measure_energy) against qmps_tpu at complex128.  No generator
reproduces JAX's Gumbel draws, so the deterministic parts (the basis
changes, the rotated states, their probabilities, the swap-test circuit)
are held to JAX's at 1e-12, and the estimates to the exact values within
the bounds of tests/test_noise_sampling.py's TestSampling."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import to_np
from qmps_torch.circuits import ansatze as tans
from qmps_torch.circuits.ir import circuit_state
from qmps_torch.core.linalg import random_unitary
from qmps_torch.env.exact import get_env_exact
from qmps_torch.env.variational import bloch_vector, reduced_density_matrix, state_circuit_psi
from qmps_torch.ham.hamiltonian import tfim
from qmps_torch.objectives import sampling as ts
from qmps_torch.objectives.energy import energy_circuit
from qmps_tpu.circuits.ir import apply_unitary as japply
from qmps_tpu.objectives import sampling as js

STRINGS = [a + b for a in "IXYZ" for b in "IXYZ" if a + b != "II"]


def _psi(seed, n=3):
    x = np.random.default_rng(seed).standard_normal((2, 2**n))
    psi = x[0] + 1j * x[1]
    return psi / np.linalg.norm(psi)


def _gen(seed):
    return torch.Generator().manual_seed(seed)


@pytest.mark.parametrize("qubits", [(0, 1), (1, 2)])
def test_basis_changes_match_jax(qubits):
    """For each of the 15 Pauli strings: the ops of ``pauli_measure_ops``,
    the rotated state and its probabilities equal JAX's to 1e-12, and
    1 - 2 P(qubit 0 reads 1) is the exact <P>."""
    psi = _psi(0)
    rho = np.outer(psi, psi.conj())
    for s in STRINGS:
        ops_j, ops_t = js.pauli_measure_ops(s), ts.pauli_measure_ops(s)
        assert [w for _, w in ops_j] == [w for _, w in ops_t]
        for (Uj, _), (Ut, _) in zip(ops_j, ops_t):
            np.testing.assert_allclose(to_np(Ut), np.asarray(Uj), rtol=0, atol=1e-15)
        phi_j = jnp.asarray(psi)
        for U, w in ops_j:
            phi_j = japply(phi_j, U, tuple(qubits[i] for i in w), 3)
        phi_t = ts._measured_state(s, torch.from_numpy(psi), qubits)
        np.testing.assert_allclose(to_np(phi_t), np.asarray(phi_j), rtol=0, atol=1e-12)
        prob = np.abs(to_np(phi_t)) ** 2
        np.testing.assert_allclose(prob, np.abs(np.asarray(phi_j)) ** 2, rtol=0, atol=1e-12)
        bit = (np.arange(8) >> (2 - qubits[0])) & 1
        from qmps_torch.core.paulis import embed, pauli_string

        P = to_np(embed(pauli_string(s), qubits[0], 3))
        np.testing.assert_allclose(1 - 2 * prob[bit == 1].sum(), np.trace(rho @ P).real, rtol=0, atol=1e-12)


def test_swap_test_circuit_matches_jax():
    """The destructive swap test's state equals JAX's circuit to 1e-12,
    and its exact P(11) is (1 - Tr[rho sigma]) / 2."""
    from qmps_tpu.core import gates as jg

    a, b = _psi(1, 2), _psi(2, 2)
    psi = jnp.kron(jnp.asarray(a), jnp.asarray(b))
    for U, w in [(jg.CNOT, (0, 2)), (jg.H, (0,))]:
        psi = japply(psi, U, w, 4)
    got = to_np(ts._swap_test_state(torch.from_numpy(a), torch.from_numpy(b)))
    np.testing.assert_allclose(got, np.asarray(psi), rtol=0, atol=1e-12)
    idx = np.arange(16)
    p11 = (np.abs(got) ** 2)[((idx >> 3) & 1) * ((idx >> 1) & 1) == 1].sum()
    rho = to_np(reduced_density_matrix(torch.from_numpy(a), [0], 2))
    sigma = to_np(reduced_density_matrix(torch.from_numpy(b), [0], 2))
    np.testing.assert_allclose(p11, (1 - np.trace(rho @ sigma).real) / 2, rtol=0, atol=1e-12)


def test_sampled_bloch_vector():
    """Within 0.02 of exact at 2e5 shots (tests/test_tools.py:33-38)."""
    psi = circuit_state(tans.shallow_full_state_ops(torch.from_numpy(np.random.default_rng(3).standard_normal(15)))[0], 2)
    exact = to_np(bloch_vector(reduced_density_matrix(psi, [0], 2)))
    got = to_np(ts.sampled_bloch_vector(_gen(1), psi, 0, 2, shots=200000))
    assert np.max(np.abs(got - exact)) < 0.02


def test_sampled_energy():
    """Within 5e-2 of exact at 1e5 shots a string (tests/test_ground_state.py:
    77-90), through ``measure_energy`` and ``Hamiltonian.measure_energy``,
    fresh shots on every call."""
    U = random_unitary(_gen(5), 4)
    V = get_env_exact(U)
    psi = state_circuit_psi(U, V, 2)
    exact = energy_circuit(U, tfim(1.0).to_matrix(), V).item()
    g = _gen(2)
    e1 = ts.measure_energy(g, tfim(1.0).strings, psi, qubits=(1, 2), shots=100000).item()
    e2 = tfim(1.0).measure_energy(g, psi, shots=100000).item()
    assert abs(e1 - exact) < 5e-2 and abs(e2 - exact) < 5e-2 and e1 != e2


def test_sampled_trace_distance():
    U = random_unitary(_gen(6), 4)
    V = get_env_exact(U)
    # the exact environment: zero within shot noise (~4e-3 a component)
    td = ts.sampled_trace_distance(_gen(3), U, V, shots=60000).item()
    assert td < 2e-2
    td_bad = ts.sampled_trace_distance(_gen(4), U, random_unitary(_gen(9), 4), shots=60000).item()
    assert td_bad > td + 5e-2


def test_sampled_p0_and_noisy_p0():
    """The all-zero fraction of a state, and the binomial estimate of a
    density matrix's P(0...0), each within 5 standard errors at 5e4 shots."""
    psi = torch.from_numpy(_psi(7))
    p0 = abs(psi[0].item()) ** 2
    shots = 50000
    sd = (p0 * (1 - p0) / shots) ** 0.5
    assert abs(ts.sampled_p0(_gen(1), psi, shots).item() - p0) < 5 * sd
    rho = torch.outer(psi, psi.conj())
    assert abs(ts.sampled_noisy_p0(_gen(2), rho, shots).item() - p0) < 5 * sd
    g = _gen(3)
    assert ts.sampled_noisy_p0(g, rho, shots).item() != ts.sampled_noisy_p0(g, rho, shots).item()
