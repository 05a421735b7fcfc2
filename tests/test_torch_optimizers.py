"""qmps_torch's reference-named optimizer classes and find_ground_state's
rotosolve and scipy methods (algorithms.ground_state) and the circuit
energies (objectives.energy) against qmps_tpu at complex128: the eight
classes' objectives and the energies with their gradients to 1e-10,
find_ground_state with rotosolve and Nelder-Mead reaching JAX's energy,
fresh shot noise on every sampled evaluation, and the tests of
tests/test_capabilities.py and tests/test_ground_state.py on the classes."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import to_np
from qmps_torch.algorithms import ground_state as tgs
from qmps_torch.ham.exact import tfim_gs_energy_f64
from qmps_torch.ham.hamiltonian import tfim
from qmps_torch.objectives import energy as ten
from qmps_tpu.algorithms import ground_state as jgs
from qmps_tpu.ham import tfim as jtfim
from qmps_tpu.objectives import energy as jen

H1 = tfim(1.0).to_matrix()


def _p(n, seed=0, scale=0.5):
    return np.random.default_rng(seed).standard_normal(n) * scale


def _same_objective(opt_j, opt_t, x, atol=1e-10):
    np.testing.assert_allclose(opt_t.objective_function(torch.from_numpy(x)).item(),
                               float(opt_j.objective_function(jnp.asarray(x))), rtol=0, atol=atol)


def test_exact_env_classes_match_jax():
    """NonSparseFullEnergyOptimizer (D = 2 and 4), SparseFullEnergyOptimizer
    (the "cnot" ansatz, and the joint environment), NonSparseFullTwoSite-
    EnergyOptimizer and GuessInitialFullParameterOptimizer: objectives at
    the same parameters to 1e-10."""
    for D in (2, 4):
        _same_objective(jgs.NonSparseFullEnergyOptimizer(jtfim(1.0), D=D),
                        tgs.NonSparseFullEnergyOptimizer(tfim(1.0), D=D, device="cpu"), _p((2 * D) ** 2 - 1))
    _same_objective(jgs.SparseFullEnergyOptimizer(jtfim(1.0), depth=4, ansatz="cnot"),
                    tgs.SparseFullEnergyOptimizer(tfim(1.0), depth=4, ansatz="cnot", device="cpu"), _p(8, 1))
    _same_objective(jgs.SparseFullEnergyOptimizer(jtfim(1.0), optimize_environment=True),
                    tgs.SparseFullEnergyOptimizer(tfim(1.0), optimize_environment=True, device="cpu"), _p(30, 2))
    _same_objective(jgs.NonSparseFullTwoSiteEnergyOptimizer(jtfim(1.0)),
                    tgs.NonSparseFullTwoSiteEnergyOptimizer(tfim(1.0), device="cpu"), _p(30, 3))
    target = np.linalg.qr(np.random.default_rng(4).standard_normal((4, 4)) + 1j)[0]
    _same_objective(jgs.GuessInitialFullParameterOptimizer(jnp.asarray(target)),
                    tgs.GuessInitialFullParameterOptimizer(torch.from_numpy(target), device="cpu"), _p(15, 5, 0.3))


def test_noisy_classes_match_jax():
    """NoisyNonSparseFullEnergyOptimizer in both modes (the trajectories
    from JAX's frozen key, its 256 uniforms handed over) and
    NoisySparseFullEnergyOptimizer: objectives to 1e-10."""
    x = _p(15, 6)
    _same_objective(jgs.NoisyNonSparseFullEnergyOptimizer(jtfim(1.0), 3e-3),
                    tgs.NoisyNonSparseFullEnergyOptimizer(tfim(1.0), 3e-3, device="cpu"), x)
    opt_j = jgs.NoisyNonSparseFullEnergyOptimizer(jtfim(1.0), 3e-3, simulation="trajectories", n_traj=64)
    opt_t = tgs.NoisyNonSparseFullEnergyOptimizer(tfim(1.0), 3e-3, simulation="trajectories", n_traj=64,
                                                  device="cpu")
    keys = jax.random.split(opt_j.traj_key, 64)
    opt_t._us = torch.from_numpy(np.array(jax.vmap(lambda k: jax.random.uniform(k, (37, 4)))(keys)))
    _same_objective(opt_j, opt_t, x)
    _same_objective(jgs.NoisySparseFullEnergyOptimizer(jtfim(1.0), 1e-3, depth=2),
                    tgs.NoisySparseFullEnergyOptimizer(tfim(1.0), 1e-3, depth=2, device="cpu"), _p(4, 7))


def test_circuit_energies_and_gradients_match_jax():
    """``energy_circuit`` (exact and given environments),
    ``energy_two_site`` and ``energy_joint_env_purity`` and their
    gradients in the parameters, to 1e-10; the circuit and the fast path
    agree (tests/test_ground_state.py:44-56, 117-132, with h = XY + YX)."""
    from qmps_torch.circuits.ansatze import full_state_su4 as t_su4, shallow_full_state as t_f15
    from qmps_tpu.circuits.ansatze import full_state_su4 as j_su4, shallow_full_state as j_f15

    X, Y = np.array([[0, 1], [1, 0]]), np.array([[0, -1j], [1j, 0]])
    hxy = np.kron(X, Y) + np.kron(Y, X)
    cases = [
        (lambda p: jen.energy_circuit(j_f15(p), hxy), lambda p: ten.energy_circuit(t_f15(p), hxy), 15),
        (lambda p: jen.energy_two_site(j_su4(p[:15]), j_su4(p[15:]), H1),
         lambda p: ten.energy_two_site(t_su4(p[:15]), t_su4(p[15:]), H1), 30),
        (lambda p: jen.energy_joint_env_purity(p, H1), lambda p: ten.energy_joint_env_purity(p, H1), 30),
    ]
    for k, (fj, ft, n) in enumerate(cases):
        x = _p(n, 10 + k)
        vj, gj = jax.value_and_grad(fj)(jnp.asarray(x))
        xt = torch.tensor(x, requires_grad=True)
        v = ft(xt)
        v.backward()
        np.testing.assert_allclose(v.item(), float(vj), rtol=0, atol=1e-10)
        np.testing.assert_allclose(to_np(xt.grad), np.asarray(gj), rtol=0, atol=1e-10)
    x = torch.from_numpy(_p(15, 13))
    np.testing.assert_allclose(ten.energy_circuit(t_f15(x), hxy).item(),
                               ten.energy_exact_env(t_f15(x), hxy).item(), atol=1e-10)


def _jax_start(n=15, key=0, scale=0.5):
    return torch.from_numpy(np.array(jax.random.normal(jax.random.PRNGKey(key), (n,)) * scale))


@pytest.mark.parametrize("method,steps,atol", [("rotosolve", 30, 1e-10), ("Nelder-Mead", 10000, 1e-6)])
def test_find_ground_state_methods_reach_jax(method, steps, atol):
    """find_ground_state from JAX's initial guess: rotosolve (3 sweeps of
    double rotosolve, deterministic) to JAX's energy at 1e-10, and the
    scipy Nelder-Mead bridge (tol 1e-8; the two simplexes may part on
    rounding) to its converged energy at 1e-6.  JAX's bridge runs scipy at
    maxiter 10,000 whatever ``steps`` is; the port's at ``steps``, so both
    are given 10,000."""
    rj = jgs.find_ground_state(jtfim(1.0), D=2, ansatz="suN", method=method, steps=steps)
    rt = tgs.find_ground_state(tfim(1.0), D=2, ansatz="suN", method=method, steps=steps, initial_guess=_jax_start())
    print(method, rt.energy - rj.energy, rt.energy - tfim_gs_energy_f64(1.0))
    np.testing.assert_allclose(rt.energy, rj.energy, rtol=0, atol=atol)
    if method == "rotosolve":
        np.testing.assert_allclose(to_np(rt.params), np.asarray(rj.params), rtol=0, atol=1e-10)
        np.testing.assert_allclose(to_np(rt.history), np.asarray(rj.history), rtol=0, atol=1e-10)


def test_sampled_optimizer():
    """The sampled objective tracks the exact energy (5e-2 at 2e5 shots,
    tests/test_capabilities.py:60-72), draws fresh shot noise at every
    evaluation (:215-228), and refuses the gradient optimizers (JAX's
    :449-458)."""
    from qmps_torch.circuits.ansatze import shallow_cnot_state

    opt = tgs.NoisySparseSampledEnergyOptimizer(tfim(1.0), n_samples=200000, depth=2, device="cpu")
    p = opt.initial_guess
    exact = ten.energy_exact_env(shallow_cnot_state(2, p), H1).item()
    assert abs(opt.objective_function(p).item() - exact) < 5e-2
    small = tgs.NoisySparseSampledEnergyOptimizer(tfim(1.0), n_samples=2000, device="cpu")
    vals = [small.objective_function(small.initial_guess).item() for _ in range(3)]
    assert len(set(vals)) == 3
    for method in ("adam", "lbfgs", "rotosolve"):
        small.change_settings({"method": method})
        with pytest.raises(ValueError):
            small.optimize()
    with pytest.raises(TypeError):
        tgs.NoisySparseSampledEnergyOptimizer(H1, device="cpu")


def test_scipy_methods_take_maxiter():
    """The optimizer's ``maxiter`` setting bounds a scipy method's
    iterations (JAX's bridge runs 10,000 whatever it says): a short
    Nelder-Mead on the stochastic objective ends after 20, finite."""
    opt = tgs.NoisySparseSampledEnergyOptimizer(tfim(1.0), n_samples=500, depth=1, device="cpu")
    opt.change_settings({"maxiter": 20})
    res = opt.optimize()
    assert np.isfinite(res.fun) and res.x.shape == (2,) and res.nit == 20


# -- tests/test_ground_state.py's and tests/test_capabilities.py's class tests


def test_optimizer_class_wrapper():
    """tests/test_ground_state.py:74-79 from JAX's start (the torch
    generator's seed 0 lands in a basin 0.029 above, as any start may)."""
    opt = tgs.NonSparseFullEnergyOptimizer(tfim(1.5), D=2, initial_guess=_jax_start())
    opt.change_settings({"method": "lbfgs", "maxiter": 120})
    res = opt.optimize()
    assert res.fun - tfim_gs_energy_f64(1.5) < 5e-3
    assert opt.U.shape == (4, 4) and opt.obj_fun_values is not None


def test_sparse_and_two_site_optimizers():
    """tests/test_ground_state.py:81-92, from JAX's starts."""
    opt = tgs.SparseFullEnergyOptimizer(tfim(1.0), D=2, depth=4, ansatz="cnot", initial_guess=_jax_start(8))
    opt.change_settings({"method": "adam", "maxiter": 400})
    assert opt.optimize().fun - tfim_gs_energy_f64(1.0) < 2e-2
    two = tgs.NonSparseFullTwoSiteEnergyOptimizer(tfim(1.0), initial_guess=_jax_start(30))
    two.change_settings({"method": "lbfgs", "maxiter": 150})
    assert two.optimize().fun - tfim_gs_energy_f64(1.0) < 5e-3
    assert two.U1.shape == two.U2.shape == (4, 4)


def test_zero_noise_matches_noiseless():
    """prob = 0 noisy objective == the noiseless one
    (tests/test_capabilities.py:23-33)."""
    from qmps_torch.circuits.ansatze import shallow_full_state

    p = torch.from_numpy(_p(15, 2, 0.4))
    opt = tgs.NoisyNonSparseFullEnergyOptimizer(tfim(1.0), 0.0, initial_guess=p)
    np.testing.assert_allclose(opt.objective_function(p).item(),
                               ten.energy_exact_env(shallow_full_state(p), H1).item(), atol=1e-9)


@pytest.mark.slow
def test_noisy_optimization_converges_above_exact():
    """p = 1e-3 a qubit a moment: a noise floor above the exact energy, and
    within 0.25 of it (tests/test_capabilities.py:35-44)."""
    opt = tgs.NoisyNonSparseFullEnergyOptimizer(tfim(1.0), 1e-3, device="cpu")
    opt.change_settings({"method": "adam", "maxiter": 300})
    res = opt.optimize()
    assert tfim_gs_energy_f64(1.0) < res.fun < tfim_gs_energy_f64(1.0) + 0.25
