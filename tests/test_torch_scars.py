"""qmps_torch.algorithms.scars held to qmps_tpu.algorithms.scars at
float64/complex128 on the CPU: the ported tests of tests/test_scars.py,
the cost and its gradient, the stepper and the ensembles against JAX's,
the batched ensemble against single runs, and the batched energies."""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_parity  # noqa: F401  (one torch thread per worker)
import qmps_tpu.algorithms.scars as js
import qmps_torch.algorithms.scars as ts
from qmps_torch.circuits.ansatze import scars_ansatz, scars_tensor
from qmps_torch.embed import unitary_to_tensor
from qmps_torch.mps import iMPS

MU = 0.325
P0 = [0.6, 0.9, 1.1, 0.4]
CPU = torch.device("cpu")


def _t(x):
    return torch.tensor(np.asarray(x), dtype=torch.float64)


# -- the tests of tests/test_scars.py ------------------------------------------


def test_scars_circuit_matches_analytic_tensor():
    """The 2-qubit scars circuit embeds the analytic A(theta, phi) up to
    gauge: the two states overlap to 1."""
    th, ph = 0.7, 1.3
    A_circ = unitary_to_tensor(scars_ansatz(torch.tensor([th, ph], dtype=torch.float64)))
    A_ref = scars_tensor(th, ph)
    ov = float(iMPS([A_circ]).overlap(iMPS([A_ref])))
    np.testing.assert_allclose(ov, 1.0, atol=1e-8)


def test_scars_cost_self_identity():
    """W = I, same params: perfect overlap."""
    p = _t(P0)
    W = torch.eye(16, dtype=torch.complex128)
    np.testing.assert_allclose(float(ts.scars_cost(p, p, W)), -1.0, atol=1e-8)


@pytest.mark.slow
def test_quantum_matches_classical_odes():
    """Short-horizon agreement of the variational quantum evolution with the
    classical TDVP equations (scars.py:171-199)."""
    dt, steps = 0.05, 12
    ev = ts.ScarsEvolver(MU, dt, inner_steps=200, lr=1e-2)
    qtraj = ev.simulate(_t(P0), steps).numpy()
    ctraj = np.mod(ts.classical_trajectory(_t(P0), torch.arange(steps, dtype=torch.float64) * dt, MU).numpy(),
                   2 * np.pi)
    err = np.max(np.abs(np.angle(np.exp(1j * (qtraj - ctraj)))))
    assert err < 0.05, err


def test_classical_poincare_sweep_and_sections():
    y0s = _t(jax.random.normal(jax.random.PRNGKey(0), (4, 4)))
    trajs = ts.classical_poincare_sweep(y0s, torch.linspace(0, 20, 400, dtype=torch.float64), MU)
    assert trajs.shape == (4, 400, 4)
    assert torch.isfinite(trajs).all()
    secs = ts.poincare_sections(torch.remainder(trajs, 2 * math.pi))
    assert len(secs) == 4


def test_scars_energy_finite():
    assert np.isfinite(float(ts.scars_energy(_t(P0), MU)))


def test_quantum_poincare_sweep_matches_jax():
    """The JAX sweep test's shape (8 uniform starts in [0.5, 1.5), 3 steps of
    10 inner steps, mu 0.4): the port's one batched adam against JAX's
    vmapped sweep, 1e-8 in the wrapped angles."""
    y0s = jax.random.uniform(jax.random.PRNGKey(0), (8, 4), minval=0.5, maxval=1.5)
    ref = np.asarray(js.quantum_poincare_sweep(y0s, 0.4, 0.05, 3, inner_steps=10))
    out = ts.quantum_poincare_sweep(_t(y0s), 0.4, 0.05, 3, inner_steps=10).numpy()
    assert out.shape == ref.shape == (8, 3, 4)
    d = np.abs(np.angle(np.exp(1j * (out - ref))))
    assert d.max() < 1e-8, d.max()


def test_poincare_sections_seam_and_empty_shape():
    """No spurious crossings from the 0/2-pi wrap seam, and the empty case
    has the documented (0, len(coords)) shape."""
    t = np.linspace(0, 20, 400)
    seam_orbit = np.stack([0.5 + 0 * t, np.mod(0.3 * np.sin(t), 2 * np.pi), 1 + 0 * t, 2 + 0 * t], axis=1)
    winding = np.stack([0.5 + 0 * t, np.mod(0.7 * t, 2 * np.pi), 1 + 0 * t, 2 + 0 * t], axis=1)
    secs = ts.poincare_sections(torch.tensor(np.stack([seam_orbit, winding])))
    assert secs[0].shape == (0, 2)
    assert secs[1].shape == (2, 2)
    ref = js.poincare_sections(np.stack([seam_orbit, winding]))
    for a, b in zip(secs, ref):
        np.testing.assert_array_equal(a, b)


# -- parity with the JAX package ------------------------------------------------


def test_scars_tensor_batches_and_keeps_its_0d_output():
    rng = np.random.default_rng(3)
    th, ph = rng.uniform(0, 2 * np.pi, (2, 5, 3))
    batched = scars_tensor(torch.tensor(th), torch.tensor(ph))
    assert batched.shape == (5, 3, 2, 2, 2)
    for i in range(5):
        for j in range(3):
            one = scars_tensor(float(th[i, j]), float(ph[i, j]))
            assert torch.equal(batched[i, j], one)
            np.testing.assert_allclose(one.numpy(), np.asarray(js.scars_tensor(th[i, j], ph[i, j])), atol=1e-15)
    assert scars_tensor(0.7, 1.3).shape == (2, 2, 2)


def test_blocked_tensor_and_gate_match_jax():
    rng = np.random.default_rng(4)
    p = rng.uniform(0, 2 * np.pi, (6, 4))
    np.testing.assert_allclose(ts.blocked_tensor(_t(p)).numpy(),
                               np.stack([np.asarray(js.blocked_tensor(jnp.asarray(q))) for q in p]), atol=1e-14)
    np.testing.assert_allclose(ts.scars_W(MU, 0.2).numpy(), np.asarray(js.scars_W(MU, 0.2)), atol=1e-14)


def test_scars_cost_and_gradient_match_jax():
    """The cost at d = 4 (W 16 x 16, E 4 x 4) batched over 5 candidates and
    its gradient against conj(jax.grad) (the angles are real: equal), 1e-10."""
    rng = np.random.default_rng(5)
    cur = rng.uniform(0.3, 2.8, (5, 4))
    cand = cur + 0.05 * rng.standard_normal((5, 4))
    W = js.scars_W(MU, 0.2)
    ref_v, ref_g = jax.vmap(jax.value_and_grad(js.scars_cost), (0, 0, None))(jnp.asarray(cand), jnp.asarray(cur), W)
    x = _t(cand).requires_grad_()
    v = ts.scars_cost(x, _t(cur), ts.scars_W(MU, 0.2))
    v.sum().backward()
    np.testing.assert_allclose(v.detach().numpy(), np.asarray(ref_v), atol=1e-10)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(ref_g), atol=1e-10)


def test_simulate_matches_jax():
    """ScarsEvolver.simulate, 3 steps of 10 inner steps, 1e-8."""
    ref = np.asarray(js.ScarsEvolver(MU, 0.05, inner_steps=10).simulate(jnp.asarray(P0), 3))
    out = ts.ScarsEvolver(MU, 0.05, inner_steps=10).simulate(_t(P0), 3).numpy()
    assert out.shape == ref.shape == (3, 4)
    assert np.abs(np.angle(np.exp(1j * (out - ref)))).max() < 1e-8


def test_step_returns_the_cost_at_the_returned_angles():
    ev = ts.ScarsEvolver(MU, 0.05, inner_steps=10)
    p, v = ev._step(_t(P0))
    np.testing.assert_allclose(float(v), float(ts.scars_cost(p, _t(P0), ev.W)), atol=1e-14)


def test_ensemble_equals_single_evolvers():
    """One adam over the (B, 4) angles of the ensemble equals B separate
    ScarsEvolver runs at the same rate, 1e-10."""
    rng = np.random.default_rng(6)
    y0s = rng.uniform(0.5, 1.5, (4, 4))
    ens = ts.quantum_poincare_sweep(_t(y0s), MU, 0.05, 3, inner_steps=10).numpy()
    ev = ts.ScarsEvolver(MU, 0.05, inner_steps=10, lr=2e-2)
    singles = np.stack([ev.simulate(_t(y), 3).numpy() for y in y0s])
    assert np.abs(np.angle(np.exp(1j * (ens - singles)))).max() < 1e-10


def test_classical_trajectory_matches_jax():
    ts_ = np.arange(12) * 0.05
    ref = np.asarray(js.classical_trajectory(jnp.asarray(P0), jnp.asarray(ts_), MU))
    out = ts.classical_trajectory(_t(P0), _t(ts_), MU).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-10)
    y = _t(np.random.default_rng(7).uniform(0.3, 2.8, (3, 4)))
    for f, g in ((ts.dtheta_dt, js.dtheta_dt), (ts.dphi_dt, js.dphi_dt)):
        np.testing.assert_allclose(f(*y.unbind(-1)).numpy(), np.asarray(g(*jnp.asarray(y.numpy()).T)), atol=1e-12)


def test_scars_energy_batched_matches_jax_and_central_differences():
    """Energies of 6 starts in one call against JAX's (1e-12); gradients
    against central differences of JAX's energy (1e-8).  JAX's own gradient
    is NaN: the scars tensors are left-canonical, so the gauge matrix is a
    multiple of the identity, where the SVD adjoint of its pseudo-inverse
    divides 0 by 0; the port differentiates the pseudo-inverse itself
    (mps/imps._PinvTri)."""
    rng = np.random.default_rng(8)
    p = rng.uniform(0.3, 2.8, (6, 4))
    ref = np.asarray(jax.vmap(lambda q: js.scars_energy(q, MU))(jnp.asarray(p)))
    x = _t(p).requires_grad_()
    e = ts.scars_energy(x, MU)
    np.testing.assert_allclose(e.detach().numpy(), ref, atol=1e-12)
    e.sum().backward()
    h = 1e-5
    shifts = h * np.eye(4)
    energies = jax.jit(jax.vmap(lambda q: js.scars_energy(q, MU)))
    plus = np.asarray(energies(jnp.asarray((p[:, None, :] + shifts).reshape(-1, 4)))).reshape(6, 4)
    minus = np.asarray(energies(jnp.asarray((p[:, None, :] - shifts).reshape(-1, 4)))).reshape(6, 4)
    np.testing.assert_allclose(x.grad.numpy(), (plus - minus) / (2 * h), atol=1e-8)
    assert np.isnan(np.asarray(jax.grad(lambda q: js.scars_energy(q, MU))(jnp.asarray(p[0])))).all()


def test_constant_energy_starts_lie_on_the_shell():
    """Torch-seeded starts, projected onto the energy of p0 (the JAX
    package's projection of its own starts is NaN, as its gradient is):
    each start within 1e-5 of the shell, the same seed the same starts, a
    generator accepted as the seed's."""
    target = float(ts.scars_energy(_t(P0), MU))
    p = ts.constant_energy_initial_conditions(0, 6, MU, target, steps=300, device=CPU)
    assert p.shape == (6, 4) and p.dtype == torch.float64
    assert (ts.scars_energy(p, MU) - target).abs().max() < 1e-5
    once = ts.constant_energy_initial_conditions(0, 6, MU, target, steps=5, device=CPU)
    again = ts.constant_energy_initial_conditions(torch.Generator().manual_seed(0), 6, MU, target, steps=5,
                                                  device=CPU)
    assert torch.equal(once, again)
    p0s = jax.random.uniform(jax.random.PRNGKey(0), (4, 4), minval=0.1, maxval=2 * jnp.pi - 0.1)
    assert np.isnan(np.asarray(js.constant_energy_initial_conditions(jax.random.PRNGKey(0), 4, MU, target,
                                                                     steps=3))).any()
    projected = ts._project_from_starts(_t(p0s), MU, target, 300, 5e-2)
    assert (ts.scars_energy(projected, MU) - target).abs().max() < 1e-5


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("the rule is checked where there is no card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ts.classical_trajectory(P0, [0.0, 0.1], MU)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ts.ScarsEvolver(MU, 0.05, inner_steps=2).simulate(P0, 2)
