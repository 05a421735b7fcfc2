"""qmps_torch's depolarizing-noise density-matrix path
(objectives.noise) against qmps_tpu at complex128: the superoperator
channel against the JAX package's literal loop of Pauli conjugations, the
noisy circuits, energies and TDVP objectives with their gradients in the
parameters and in p, and tests/test_noise_sampling.py's TestNoise."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.linalg
import torch

from _torch_parity import to_np
from qmps_torch.circuits import ansatze as tans
from qmps_torch.circuits.ir import apply_unitary, circuit_state
from qmps_torch.env.exact import get_env_exact
from qmps_torch.ham.hamiltonian import tfim
from qmps_torch.mps.imps import iMPS
from qmps_torch.objectives import noise as tn
from qmps_torch.objectives.energy import energy_circuit
from qmps_torch.objectives.overlap import tdvp_objective
from qmps_tpu.circuits import ansatze as jans
from qmps_tpu.env.exact import get_env_exact as jget_env_exact
from qmps_tpu.mps.imps import iMPS as jiMPS
from qmps_tpu.objectives import noise as jn

H1 = tfim(1.0).to_matrix()


def _rho(rng, n):
    x = rng.standard_normal((2**n, 2**n)) + 1j * rng.standard_normal((2**n, 2**n))
    rho = x @ x.conj().T
    return rho / np.trace(rho)


def _tdvp_inputs(seed=0):
    """Left-canonical A and a nearby B (JAX's canonical forms), and a TFIM
    Trotter gate."""
    A = np.asarray(jiMPS.random(jax.random.PRNGKey(seed), 2, 2).left_canonicalise()[0])
    B = np.asarray(jiMPS.random(jax.random.PRNGKey(seed + 1), 2, 2).left_canonicalise()[0])
    W = scipy.linalg.expm(-1j * 0.04 * tfim(0.2).to_matrix())
    return A.copy(), B.copy(), W


@pytest.mark.parametrize("n", [3, 4, 5, 6])
def test_superoperator_matches_the_literal_loop(n):
    """S(p) on the pair (ket_q, bra_q), in the matrix layout
    (``depolarize_qubit``) and in the paired layout the circuits use, equals
    the JAX package's (1 - p) rho + (p/3) sum P rho P on every qubit of a
    random rho, to 1e-12."""
    rng = np.random.default_rng(n)
    rho = _rho(rng, n)
    for q in range(n):
        want = np.asarray(jn.depolarize_qubit(jnp.asarray(rho), q, n, 0.07))
        got = tn.depolarize_qubit(torch.from_numpy(rho), q, n, 0.07)
        np.testing.assert_allclose(to_np(got), want, rtol=0, atol=1e-12)
        paired = apply_unitary(tn._to_pairs(torch.from_numpy(rho), n), tn.depolarizing_superop(0.07), (q,), n, d=4)
        np.testing.assert_allclose(to_np(tn._from_pairs(paired, n)), want, rtol=0, atol=1e-12)


def test_noisy_circuit_rho_matches_jax():
    """The full15 circuit at p = 0, 1e-2, 0.1 to 1e-12, from |00><00| and
    from a random rho0; a (3,) tensor p gives the three levels as one
    batch, row by row the same."""
    p15 = np.random.default_rng(1).standard_normal(15)
    ops_j, n = jans.shallow_full_state_ops(jnp.asarray(p15))
    ops_t, _ = tans.shallow_full_state_ops(torch.from_numpy(p15))
    levels = (0.0, 1e-2, 0.1)
    batched = tn.noisy_circuit_rho(ops_t, n, torch.tensor(levels, dtype=torch.float64))
    assert batched.shape == (3, 4, 4)
    for k, p in enumerate(levels):
        want = np.asarray(jn.noisy_circuit_rho(ops_j, n, p))
        np.testing.assert_allclose(to_np(tn.noisy_circuit_rho(ops_t, n, p)), want, rtol=0, atol=1e-12)
        np.testing.assert_allclose(to_np(batched[k]), want, rtol=0, atol=1e-12)
    rho0 = _rho(np.random.default_rng(11), n)
    np.testing.assert_allclose(to_np(tn.noisy_circuit_rho(ops_t, n, 0.05, rho0=torch.from_numpy(rho0))),
                               np.asarray(jn.noisy_circuit_rho(ops_j, n, 0.05, rho0=jnp.asarray(rho0))),
                               rtol=0, atol=1e-12)


def test_noisy_energy_and_gradients_match_jax():
    """``noisy_energy`` (the State(U, V, 2) circuit) at p = 0 and 3e-3 to
    1e-10: the full15 state with its exact environment, and, with its
    gradient in the parameters and in p, the depth-1 "cnot" state on a
    fixed environment (a circuit of 13 moments; the full15 one's gradient
    program takes JAX ~20 s to compile)."""
    p15 = np.random.default_rng(2).standard_normal(15) * 0.5
    ops_j, n = jans.shallow_full_state_ops(jnp.asarray(p15))
    ops_t, _ = tans.shallow_full_state_ops(torch.from_numpy(p15))
    Vj = jget_env_exact(jans.shallow_full_state(jnp.asarray(p15)))
    Vt = get_env_exact(tans.shallow_full_state(torch.from_numpy(p15)))
    np.testing.assert_allclose(to_np(Vt), np.asarray(Vj), rtol=0, atol=1e-12)
    for p in (0.0, 3e-3):
        np.testing.assert_allclose(tn.noisy_energy(ops_t, n, Vt, H1, p).item(),
                                   float(jn.noisy_energy(ops_j, n, Vj, H1, p)), rtol=0, atol=1e-10)

    V = np.linalg.qr(np.random.default_rng(3).standard_normal((4, 4)) + 1j)[0]

    def energy_j(q, p):
        ops, n = jans.shallow_cnot_state_ops(2, q)
        return jn.noisy_energy(ops, n, jnp.asarray(V), H1, p)

    vg = jax.jit(jax.value_and_grad(energy_j, argnums=(0, 1)))
    q0 = p15[:2]
    for p in (0.0, 3e-3):
        vj, (gj, gpj) = vg(jnp.asarray(q0), p)
        x = torch.tensor(q0, requires_grad=True)
        pt = torch.tensor(p, dtype=torch.float64, requires_grad=True)
        ops, n = tans.shallow_cnot_state_ops(2, x)
        v = tn.noisy_energy(ops, n, torch.from_numpy(V), H1, pt)
        v.backward()
        np.testing.assert_allclose(v.item(), float(vj), rtol=0, atol=1e-10)
        np.testing.assert_allclose(to_np(x.grad), np.asarray(gj), rtol=0, atol=1e-10)
        np.testing.assert_allclose(float(pt.grad), float(gpj), rtol=0, atol=1e-10)


def test_noisy_tdvp_objective_and_gradients_match_jax():
    """``noisy_tdvp_amplitude`` and ``noisy_tdvp_objective`` (the 6-qubit
    Bell-form circuit, the mixed fixed point inside) at p = 0, 1e-3, 3e-2,
    and the objective's gradient in B's full15 parameters and in p, to
    1e-10; a batch of noise levels with a batch of candidates equals the
    rows."""
    A, _, W = _tdvp_inputs()
    p15 = np.random.default_rng(3).standard_normal(15) * 0.4

    def obj_j(q, p):
        from qmps_tpu.embed.unitaries import unitary_to_tensor

        return jn.noisy_tdvp_objective(jnp.asarray(A), unitary_to_tensor(jans.shallow_full_state(q)),
                                       jnp.asarray(W), p)

    def obj_t(q, p):
        from qmps_torch.embed.unitaries import unitary_to_tensor

        return tn.noisy_tdvp_objective(torch.from_numpy(A), unitary_to_tensor(tans.shallow_full_state(q)),
                                       torch.from_numpy(W), p)

    levels = (0.0, 1e-3, 3e-2)
    vg = jax.jit(jax.value_and_grad(obj_j, argnums=(0, 1)))
    for p in levels:
        vj, (gj, gpj) = vg(jnp.asarray(p15), p)
        x = torch.tensor(p15, requires_grad=True)
        pt = torch.tensor(p, dtype=torch.float64, requires_grad=True)
        v = obj_t(x, pt)
        v.backward()
        np.testing.assert_allclose(v.item(), float(vj), rtol=0, atol=1e-10)
        np.testing.assert_allclose(to_np(x.grad), np.asarray(gj), rtol=0, atol=1e-10)
        np.testing.assert_allclose(float(pt.grad), float(gpj), rtol=0, atol=1e-10)
    qs = torch.from_numpy(np.random.default_rng(4).standard_normal((3, 15)) * 0.4)
    rows = obj_t(qs, torch.tensor(levels, dtype=torch.float64))
    for k, p in enumerate(levels):
        np.testing.assert_allclose(rows[k].item(), float(vg(jnp.asarray(qs[k].numpy()), p)[0]), rtol=0, atol=1e-12)


def test_gradcheck_in_the_parameters_and_p():
    """torch.autograd.gradcheck of the noisy TDVP objective in (B's
    parameters, p) at complex128 (both real, so torch's .grad is
    jax.grad here)."""
    from qmps_torch.embed.unitaries import unitary_to_tensor

    A, _, W = _tdvp_inputs(5)
    At, Wt = torch.from_numpy(A), torch.from_numpy(W)
    x = torch.tensor(np.random.default_rng(6).standard_normal(15) * 0.4, requires_grad=True)
    p = torch.tensor(2e-2, dtype=torch.float64, requires_grad=True)
    assert torch.autograd.gradcheck(
        lambda q, s: tn.noisy_tdvp_objective(At, unitary_to_tensor(tans.shallow_full_state(q)), Wt, s),
        (x, p), eps=1e-6, atol=1e-7)


# -- tests/test_noise_sampling.py's TestNoise, on the port --------------------


def test_zero_noise_matches_pure_state():
    ops, n = tans.shallow_full_state_ops(torch.from_numpy(np.random.default_rng(7).standard_normal(15)))
    rho = tn.noisy_circuit_rho(ops, n, 0.0)
    psi = circuit_state(ops, n)
    np.testing.assert_allclose(to_np(rho), to_np(torch.outer(psi, psi.conj())), atol=1e-10)


def test_noisy_rho_is_valid_state():
    ops, n = tans.shallow_full_state_ops(torch.from_numpy(np.random.default_rng(8).standard_normal(15)))
    rho = to_np(tn.noisy_circuit_rho(ops, n, 0.01))
    np.testing.assert_allclose(np.trace(rho), 1.0, atol=1e-10)
    np.testing.assert_allclose(rho, rho.conj().T, atol=1e-14)
    assert np.linalg.eigvalsh(rho).min() > -1e-12


def test_noisy_energy_zero_noise_parity():
    """p = 0 noisy energy == the noiseless circuit energy
    (tests/test_ground_state.py:135-148)."""
    p15 = torch.from_numpy(np.random.default_rng(9).standard_normal(15))
    U = tans.shallow_full_state(p15)
    V = get_env_exact(U)
    ops, n = tans.shallow_full_state_ops(p15)
    np.testing.assert_allclose(float(tn.noisy_energy(ops, n, V, H1, 0.0)), float(energy_circuit(U, H1, V)),
                               atol=1e-9)


@pytest.mark.slow
def test_noise_raises_energy_of_ground_state():
    """Depolarization pushes the TFIM ground-state energy up."""
    from qmps_torch.algorithms import find_ground_state

    gs = find_ground_state(tfim(1.0), D=2, ansatz="full15", method="lbfgs", steps=150, device="cpu")
    ops, n = tans.shallow_full_state_ops(gs.params)
    V = get_env_exact(gs.U)
    assert float(tn.noisy_energy(ops, n, V, H1, 0.01)) > float(tn.noisy_energy(ops, n, V, H1, 0.0)) + 1e-4


def test_noisy_tdvp_objective_limits():
    A = iMPS.random(torch.Generator().manual_seed(0), 2, 2, device="cpu").left_canonicalise()[0]
    W = torch.eye(4, dtype=torch.complex128)
    v0 = float(tn.noisy_tdvp_objective(A, A, W, 0.0))
    # p = 0: -sqrt(2 sqrt(P0)) with P0 = |x|^2 / 4 = 1/4 -> -1
    np.testing.assert_allclose(v0, -1.0, atol=1e-8)
    np.testing.assert_allclose(v0, float(tdvp_objective(A, A, W)), atol=1e-8)
    assert float(tn.noisy_tdvp_objective(A, A, W, 0.02)) > v0  # noise degrades the overlap


def test_noisy_sampled_tdvp_objective_tracks_exact():
    """Shots on the exact P0 (binomial), 2e4 shots: within 5 standard
    errors of the density-matrix objective, fresh on each call."""
    A, B, W = (torch.from_numpy(x) for x in _tdvp_inputs(10))
    exact = float(tn.noisy_tdvp_objective(A, B, W, 1e-2))
    g = torch.Generator().manual_seed(3)
    vals = [float(tn.noisy_sampled_tdvp_objective(A, B, W, 1e-2, g, shots=20000)) for _ in range(3)]
    # P0 ~ |x|^2 / 4 ~ 0.25: sd(P0) ~ 3e-3, the cost moves by ~ d(P0) / (2 P0^(3/4) sqrt 2)
    assert all(abs(v - exact) < 0.03 for v in vals), (vals, exact)
    assert len(set(vals)) == 3
