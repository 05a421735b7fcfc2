"""qmps_torch's rotosolve (optim.rotosolve) and the rest of optim.minimize
(minimize_scipy, minimize_bayesian, retry_until_monotone) against
qmps_tpu at complex128, and tests/test_optim.py's tests of them on the
port."""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import to_np
from qmps_torch.optim import minimize as tm
from qmps_tpu.optim import minimize as jm

# each package exports a function of the module's name
trs = importlib.import_module("qmps_torch.optim.rotosolve")
jrs = importlib.import_module("qmps_tpu.optim.rotosolve")


def _sinusoid(lib):
    def loss(p):
        return (lib.sin(2 * p[0] + 0.3) + 0.5 * lib.sin(p[0] + 1.0) + lib.cos(p[1]) + 0.2 * lib.sin(2 * p[1])
                + 0.7 * lib.sin(p[2] - 0.4) * lib.cos(p[0]) + 0.3 * lib.cos(2 * p[2] + p[1]))

    return loss


def _quad(lib):
    return lambda x: ((x - lib.arange(x.shape[0])) ** 2).sum()


@pytest.mark.parametrize("double", [True, False])
def test_rotosolve_matches_jax(double):
    """Four sweeps of (double) rotosolve on a trigonometric polynomial of
    three coupled angles: the parameters after each step and the loss
    history equal JAX's to 1e-10."""
    x0 = np.array([0.1, 0.2, -0.3])
    pj, hj = jrs.rotosolve(_sinusoid(jnp), jnp.asarray(x0), n_sweeps=4, double=double)
    pt, ht = trs.rotosolve(_sinusoid(torch), torch.from_numpy(x0), n_sweeps=4, double=double)
    np.testing.assert_allclose(to_np(pt), np.asarray(pj), rtol=0, atol=1e-10)
    np.testing.assert_allclose(to_np(ht), np.asarray(hj), rtol=0, atol=1e-10)
    step_j = jrs.double_rotosolve_step if double else jrs.rotosolve_step
    step_t = trs.double_rotosolve_step if double else trs.rotosolve_step
    np.testing.assert_allclose(to_np(step_t(_sinusoid(torch), torch.from_numpy(x0))),
                               np.asarray(step_j(_sinusoid(jnp), jnp.asarray(x0))), rtol=0, atol=1e-10)


def test_two_harmonic_minimum_matches_jax():
    """The grid and Newton minimization of P sin(2x + u) + Q sin(x + v)
    over 50 random sections, to 1e-10."""
    rng = np.random.default_rng(0)
    for P, u, Q, v in rng.standard_normal((50, 4)):
        want = float(jrs._min_two_harmonic(P, u, Q, v))
        np.testing.assert_allclose(trs._min_two_harmonic(P, u, Q, v), want, rtol=0, atol=1e-10)


def test_exact_on_sinusoid_cost():
    """One sweep lands each coordinate at a local minimum of its section
    (tests/test_optim.py::TestRotosolve::test_exact_on_sinusoid_cost)."""
    def loss(p):
        return torch.sin(2 * p[0] + 0.3) + 0.5 * torch.sin(p[0] + 1.0) + torch.cos(p[1]) + 0.2 * torch.sin(2 * p[1])

    p1 = trs.double_rotosolve_step(loss, torch.tensor([0.1, 0.2], dtype=torch.float64))
    for i in range(2):
        e = torch.eye(2, dtype=torch.float64)[i]
        for d in (1e-3, -1e-3):
            assert loss(p1 + d * e).item() >= loss(p1).item() - 1e-9


def test_scipy_bridge_matches_jax():
    """Nelder-Mead and BFGS with the autograd jac on the quadratic bowl
    (tests/test_optim.py::TestMinimize::test_scipy_bridge): the same
    converged point and value as JAX's bridge, to 1e-8 and 1e-12."""
    for method, with_grad, tol in (("Nelder-Mead", False, 1e-6), ("BFGS", True, 1e-10)):
        rj = jm.minimize_scipy(_quad(jnp), jnp.zeros(4), method=method, with_grad=with_grad)
        rt = tm.minimize_scipy(_quad(torch), torch.zeros(4, dtype=torch.float64), method=method, with_grad=with_grad)
        assert rt.fun < tol and rt.x.dtype == torch.float64
        np.testing.assert_allclose(to_np(rt.x), np.asarray(rj.x), rtol=0, atol=1e-8)
        np.testing.assert_allclose(rt.fun, rj.fun, rtol=0, atol=1e-12)
        assert rt.nit == rj.nit


def test_bayesian_fallback_equals_jax_from_the_same_seed():
    """The numpy GP-EI loop from seed 0 (JAX's with key None): the same
    evaluations, so the same x and value to 1e-12, and the bowl's minimum
    within tests/test_optim.py's bounds."""
    center = np.array([0.3, -0.6])
    rj = jm.minimize_bayesian(lambda x: jnp.sum((x - jnp.asarray(center)) ** 2), [(-1.0, 1.0)] * 2, n_calls=40)
    rt = tm.minimize_bayesian(lambda x: ((x - torch.from_numpy(center)) ** 2).sum(), [(-1.0, 1.0)] * 2,
                              n_calls=40, seed=0, device="cpu")
    assert rt.message == rj.message == "builtin GP-EI"
    np.testing.assert_allclose(to_np(rt.x), np.asarray(rj.x), rtol=0, atol=1e-12)
    np.testing.assert_allclose(rt.fun, rj.fun, rtol=0, atol=1e-12)
    assert rt.fun < 5e-2
    np.testing.assert_allclose(to_np(rt.x), center, atol=0.25)


def test_retry_until_monotone():
    """The best finite result across tries, stopping at the first that
    does not regress past ``last_best`` + eps; each try draws from the
    advancing generator."""
    calls = []

    def run_once(g):
        x = torch.rand(1, generator=g, dtype=torch.float64)
        calls.append(x.item())
        return tm.OptResult(x=x, fun=float("nan") if len(calls) == 1 else x.item())

    best = tm.retry_until_monotone(run_once, torch.Generator().manual_seed(0), max_tries=5, last_best=-1.0)
    assert len(calls) == 5 and len(set(calls)) == 5
    assert best.fun == min(calls[1:])
    calls.clear()
    best = tm.retry_until_monotone(run_once, torch.Generator().manual_seed(0), max_tries=5, last_best=2.0)
    assert len(calls) == 2 and best.fun == calls[1]
