"""qmps_torch's Monte-Carlo trajectory unraveling
(objectives.trajectories) against qmps_tpu at complex128: the states from
JAX's own uniforms to 1e-12, the estimators from them (``_uniforms``
patched to hand them over) equal to JAX's, and tests/test_trajectories.py
on the port, at its bounds."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import to_np
from qmps_torch.circuits import ansatze as tans
from qmps_torch.circuits.ir import circuit_state
from qmps_torch.core import gates as tg
from qmps_torch.env.exact import get_env_exact
from qmps_torch.ham.hamiltonian import tfim
from qmps_torch.objectives import noise as tn
from qmps_torch.objectives import trajectories as tt
from qmps_tpu.circuits import ansatze as jans
from qmps_tpu.core import gates as jg
from qmps_tpu.env.exact import get_env_exact as jget_env_exact
from qmps_tpu.mps.imps import iMPS as jiMPS
from qmps_tpu.mps.imps import random_tensor as jrandom_tensor
from qmps_tpu.objectives import trajectories as jt

H1 = tfim(1.0).to_matrix()


def _ops(g):
    return [(g.H, (0,)), (g.CNOT, (0, 1)), (g.CNOT, (1, 2)), (g.H, (2,))]


def _jax_uniforms(key, n_traj, moments, n):
    """The uniforms JAX's estimators draw: one key a trajectory."""
    keys = jax.random.split(key, n_traj)
    return np.array(jax.vmap(lambda k: jax.random.uniform(k, (moments, n)))(keys))


def _hand_over(monkeypatch, us):
    monkeypatch.setattr(tt, "_uniforms", lambda generator, shape: torch.from_numpy(us).reshape(shape))


def _tdvp_pair():
    A = jiMPS([jrandom_tensor(jax.random.PRNGKey(4), 2, 2)]).left_canonicalise().data[0]
    B = jiMPS([A + 0.03 * jrandom_tensor(jax.random.PRNGKey(5), 2, 2)]).left_canonicalise().data[0]
    return np.array(A), np.array(B)


def test_states_from_jax_uniforms():
    """64 trajectories of the 3-qubit circuit at p = 0.3 (every Pauli
    drawn often) from JAX's uniforms: the states equal JAX's
    ``trajectory_circuit_state`` to 1e-12; the states of the 6-qubit TDVP
    circuit at p = 0.05 too."""
    key = jax.random.PRNGKey(1)
    us = _jax_uniforms(key, 64, 4, 3)
    keys = jax.random.split(key, 64)
    want = np.asarray(jax.vmap(lambda k: jt.trajectory_circuit_state(_ops(jg), 3, 0.3, k))(keys))
    got = tt._trajectory_states(_ops(tg), 3, 0.3, torch.from_numpy(us))
    np.testing.assert_allclose(to_np(got), want, rtol=0, atol=1e-12)

    from qmps_tpu.mps import transfer as jtr
    from qmps_tpu.objectives.overlap import bell_tdvp_ops as jbell, mixed_transfer_with_gate as jmix
    from qmps_torch.objectives.overlap import bell_tdvp_ops

    A, B = _tdvp_pair()
    W = np.eye(4, dtype=complex)
    _, r = jtr.right_fixed_point(*jmix(jnp.asarray(A), jnp.asarray(B), jnp.asarray(W)))
    us = _jax_uniforms(key, 8, 11, 6)
    want = np.asarray(jax.vmap(lambda k: jt.trajectory_circuit_state(
        jbell(jnp.asarray(A), jnp.asarray(B), jnp.asarray(W), r), 6, 0.05, k))(jax.random.split(key, 8)))
    ops = bell_tdvp_ops(*(torch.from_numpy(x) for x in (A, B, W, np.asarray(r))))
    got = tt._trajectory_states(ops, 6, 0.05, torch.from_numpy(us))
    np.testing.assert_allclose(to_np(got), want, rtol=0, atol=1e-12)


def test_estimators_equal_jax_from_its_uniforms(monkeypatch):
    """``trajectory_rho_estimate``, ``trajectory_energy``,
    ``trajectory_tdvp_p0`` and ``trajectory_tdvp_objective`` given JAX's
    uniforms equal JAX's estimates to 1e-12."""
    key = jax.random.PRNGKey(3)
    _hand_over(monkeypatch, _jax_uniforms(key, 128, 4, 3))
    np.testing.assert_allclose(to_np(tt.trajectory_rho_estimate(_ops(tg), 3, 0.05, None, 128)),
                               np.asarray(jt.trajectory_rho_estimate(_ops(jg), 3, 0.05, key, 128)),
                               rtol=0, atol=1e-12)

    p15 = np.random.default_rng(2).standard_normal(15) * 0.5
    ops_j, n = jans.shallow_full_state_ops(jnp.asarray(p15))
    ops_t, _ = tans.shallow_full_state_ops(torch.from_numpy(p15))
    Vj = jget_env_exact(jans.shallow_full_state(jnp.asarray(p15)))
    Vt = get_env_exact(tans.shallow_full_state(torch.from_numpy(p15)))
    _hand_over(monkeypatch, _jax_uniforms(key, 64, 37, 4))
    np.testing.assert_allclose(tt.trajectory_energy(ops_t, n, Vt, H1, 0.02, None, 64).item(),
                               float(jt.trajectory_energy(ops_j, n, Vj, H1, 0.02, key, 64)), rtol=0, atol=1e-12)

    A, B = _tdvp_pair()
    W = np.eye(4, dtype=complex)
    _hand_over(monkeypatch, _jax_uniforms(key, 64, 11, 6))
    args_t = [torch.from_numpy(x) for x in (A, B, W)]
    np.testing.assert_allclose(tt.trajectory_tdvp_objective(*args_t, 0.01, None, 64).item(),
                               float(jt.trajectory_tdvp_objective(jnp.asarray(A), jnp.asarray(B), jnp.asarray(W),
                                                                  0.01, key, 64)), rtol=0, atol=1e-12)


def test_noise_levels_are_one_batch():
    """Batched A, B, r and p with (L, n_traj, moments, n) uniforms give, row
    by row, the unbatched estimates from each row's uniforms."""
    from qmps_torch.mps.transfer import right_fixed_point
    from qmps_torch.objectives.overlap import mixed_transfer_with_gate

    A, B = (torch.from_numpy(x) for x in _tdvp_pair())
    W = torch.eye(4, dtype=torch.complex128)
    As, Bs = torch.stack([A, B, A]), torch.stack([B, A, A])
    _, r = right_fixed_point(*mixed_transfer_with_gate(As, Bs, W))
    levels = torch.tensor([0.0, 1e-2, 0.2], dtype=torch.float64)
    us = torch.rand(3, 32, 11, 6, generator=torch.Generator().manual_seed(0), dtype=torch.float64)
    ops = tt.bell_tdvp_ops(As, Bs, W, r)
    batched = tt._trajectory_states(ops, 6, levels, us)
    assert batched.shape == (3, 32, 64)
    for k in range(3):
        one = tt._trajectory_states(tt.bell_tdvp_ops(As[k], Bs[k], W, r[k]), 6, float(levels[k]), us[k])
        np.testing.assert_allclose(to_np(batched[k]), to_np(one), rtol=0, atol=1e-13)
    p0 = tt.trajectory_tdvp_p0(As, Bs, W, r, levels, torch.Generator().manual_seed(1), 32)
    assert p0.shape == (3,)


# -- tests/test_trajectories.py, on the port -----------------------------------


def test_zero_noise_trajectory_is_pure_circuit():
    psi = tt.trajectory_circuit_state(_ops(tg), 3, 0.0, torch.Generator().manual_seed(0))
    np.testing.assert_allclose(to_np(psi), to_np(circuit_state(_ops(tg), 3)), atol=1e-12)


def test_rho_estimator_matches_density_matrix():
    p = 0.05
    rho_exact = to_np(tn.noisy_circuit_rho(_ops(tg), 3, p))
    rho_mc = to_np(tt.trajectory_rho_estimate(_ops(tg), 3, p, torch.Generator().manual_seed(1), 4096))
    assert np.max(np.abs(rho_mc - rho_exact)) < 0.04
    np.testing.assert_allclose(np.trace(rho_mc).real, 1.0, atol=1e-6)


def test_trajectory_energy_matches_density_matrix():
    params = torch.from_numpy(np.random.default_rng(2).standard_normal(15) * 0.5)
    ops, n = tans.shallow_full_state_ops(params)
    V = get_env_exact(tans.shallow_full_state(params))
    e_dm = tn.noisy_energy(ops, n, V, H1, 0.02).item()
    e_mc = tt.trajectory_energy(ops, n, V, H1, 0.02, torch.Generator().manual_seed(3), 512).item()
    assert abs(e_mc - e_dm) < 0.15, (e_mc, e_dm)


@pytest.mark.slow
def test_trajectory_tdvp_objective_matches_density_matrix():
    A, B = (torch.from_numpy(x) for x in _tdvp_pair())
    W = torch.eye(4, dtype=A.dtype)
    o_dm = tn.noisy_tdvp_objective(A, B, W, 0.01).item()
    o_mc = tt.trajectory_tdvp_objective(A, B, W, 0.01, torch.Generator().manual_seed(6), 1024).item()
    assert abs(o_mc - o_dm) < 0.03, (o_mc, o_dm)


def test_noisy_optimizer_trajectory_mode():
    """The optimizer's trajectory mode against its density-matrix mode
    (< 0.2 at 256 trajectories); its uniforms are drawn once and kept, so
    two evaluations agree; an unknown mode raises."""
    from qmps_torch.algorithms.ground_state import NoisyNonSparseFullEnergyOptimizer

    opt_dm = NoisyNonSparseFullEnergyOptimizer(tfim(1.0), 0.01, device="cpu")
    opt_mc = NoisyNonSparseFullEnergyOptimizer(tfim(1.0), 0.01, simulation="trajectories", n_traj=256, device="cpu")
    params = opt_dm.initial_guess
    e_dm = opt_dm.objective_function(params).item()
    e_mc = opt_mc.objective_function(params).item()
    assert abs(e_mc - e_dm) < 0.2, (e_mc, e_dm)
    assert opt_mc.objective_function(params).item() == e_mc
    with pytest.raises(ValueError):
        NoisyNonSparseFullEnergyOptimizer(tfim(1.0), 0.01, simulation="nope", device="cpu")
