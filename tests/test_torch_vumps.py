"""VUMPS of qmps_torch (mps/tdvp: _lanczos_ground, vumps_step,
vumps_ground_state, the converged wrapper, variance_certificate, two-site
cells and split_cell) against qmps_tpu's at complex128 on the CPU, from
the same numpy inputs, and the mechanics of tests/test_tdvp_classical.py's
TestVUMPS, TestVUMPSCell2 and TestVUMPSLargeD (their physics against
exact oracles is in test_torch_vumps_physics.py).

AC' and C' come from two Lanczos runs, whose ground vectors carry an
arbitrary phase: AL after a step is compared up to one global phase, the
energies and gradient norms directly.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import to_np
from qmps_torch.ham.exact import tfim_gs_energy_f64
from qmps_torch.ham.hamiltonian import tfim
from qmps_torch.mps import tdvp as ttd
from qmps_torch.mps import transfer as ttr
from qmps_torch.mps.imps import _cholesky_psd, iMPS, left_orthogonalise, random_tensor
from qmps_torch.utils.convert import from_mixed_gauge
from qmps_tpu.mps import tdvp as jtd

E1 = float(tfim_gs_energy_f64(1.0))


def _random_A(seed, D, d=2):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((d, D, D)) + 1j * rng.standard_normal((d, D, D))


def _up_to_phase(a, b):
    """a rotated by the global phase that best matches b."""
    z = np.vdot(a, b)
    return a * z / abs(z)


def _isometric(AL, atol):
    D = AL.shape[-1]
    np.testing.assert_allclose(to_np(torch.einsum("sia,sib->ab", AL.conj(), AL)), np.eye(D), atol=atol)


@pytest.fixture(scope="module")
def d4_runs():
    """JAX's and the port's vumps_ground_state at D = 4, TFIM g = 1, 60
    iterations from the same A0 (shared by the tests below)."""
    A0, h = _random_A(0, 4), tfim(1.0).to_matrix()
    return A0, jtd.vumps_ground_state(h, 4, iters=60, A0=A0), ttd.vumps_ground_state(h, 4, iters=60, A0=A0,
                                                                                        device="cpu")


def test_lanczos_ground_matches_eigh_and_jax():
    """32 Lanczos steps on a 40 x 40 hermitian matrix: the ground value
    against numpy's eigh (1e-8) and JAX's Lanczos (1e-12), the vector
    against eigh's up to phase (1e-6) and JAX's (1e-10)."""
    rng = np.random.default_rng(0)
    M = rng.standard_normal((40, 40)) + 1j * rng.standard_normal((40, 40))
    H = (M + M.conj().T) / 2
    v0 = np.ones(40, np.complex128)
    theta, v = ttd._lanczos_ground(lambda x: torch.from_numpy(H) @ x, torch.from_numpy(v0), 32)
    theta_j, v_j = jtd._lanczos_ground(lambda x: jnp.asarray(H) @ x, jnp.asarray(v0), 32)
    evals, evecs = np.linalg.eigh(H)
    assert abs(float(theta) - evals[0]) < 1e-8
    assert abs(abs(np.vdot(to_np(v), evecs[:, 0])) - 1.0) < 1e-6
    assert abs(float(theta) - float(theta_j)) < 1e-12
    np.testing.assert_allclose(_up_to_phase(to_np(v), np.asarray(v_j)), np.asarray(v_j), atol=1e-10)


def test_lanczos_breakdown_returns_exact_eigenvector():
    """Starting at an eigenvector exhausts the Krylov space at step 1: the
    padded rows inject no spurious low mode (value 1e-12, vector 1e-10)."""
    H = torch.diag(torch.tensor([-2.0, -1.0, 0.0, 1.0], dtype=torch.complex128))
    v0 = torch.tensor([0.0, 1.0, 0.0, 0.0], dtype=torch.complex128)
    theta, v = ttd._lanczos_ground(lambda x: H @ x, v0, 8)
    assert abs(float(theta) + 1.0) < 1e-12
    assert abs(abs(complex(torch.vdot(v, v0))) - 1.0) < 1e-10


@pytest.mark.parametrize("solver", ["dense", "gmres"])
def test_vumps_step_matches_jax(solver):
    """One vumps_step from JAX's mixed gauge of a random D = 4 state: AL
    and AR up to one global phase each (1e-10), C (its phase fixed by its
    trace), e and the gradient norm (1e-10)."""
    mj = tuple(np.asarray(x) for x in jtd.mixed_gauge(jnp.asarray(_random_A(1, 4))))
    h = tfim(0.8).to_matrix()
    got = ttd.vumps_step(*from_mixed_gauge(mj), torch.from_numpy(h), 24, env_solver=solver)
    want = jtd.vumps_step(*(jnp.asarray(x) for x in (*mj, h)), 24, env_solver=solver)
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_allclose(_up_to_phase(to_np(g), np.asarray(w)), np.asarray(w), atol=1e-10)
    np.testing.assert_allclose(to_np(got[2]), np.asarray(want[2]), atol=1e-10)
    assert abs(float(got[3]) - float(want[3])) < 1e-10
    assert abs(float(got[4]) - float(want[4])) < 1e-10


def test_vumps_ground_state_matches_jax(d4_runs):
    """D = 4, 60 iterations from JAX's A0: the energy (1e-10), every
    in-iteration energy and gradient norm (1e-10), and AL up to its phase
    (1e-8)."""
    _, (ALj, Cj, ej, infoj), (AL, C, e, info) = d4_runs
    assert abs(e - ej) < 1e-10
    np.testing.assert_allclose(to_np(info["energies"]), np.asarray(infoj["energies"]), atol=1e-10)
    np.testing.assert_allclose(to_np(info["grad_norms"]), np.asarray(infoj["grad_norms"]), atol=1e-10)
    np.testing.assert_allclose(_up_to_phase(to_np(AL), np.asarray(ALj)), np.asarray(ALj), atol=1e-8)


def test_vumps_reaches_machine_gradient_D4():
    """150 iterations at D = 4 (the port's seeded start): gradient < 1e-10,
    variational at the returned state, within 1e-4 of exact, AL
    left-isometric (1e-10)."""
    AL, C, e, info = ttd.vumps_ground_state(tfim(1.0).to_matrix(), 4, iters=150, device="cpu")
    assert float(info["grad_norms"][-1]) < 1e-10
    assert E1 - 1e-9 <= e < E1 + 1e-4
    _isometric(AL, 1e-10)


def test_vumps_beats_descent_at_criticality_D8():
    """D = 8, 200 iterations at g = 1: gradient < 1e-10, error < 1e-5 and a
    correlation length > 20 (descent stalls near 5)."""
    AL, C, e, info = ttd.vumps_ground_state(tfim(1.0).to_matrix(), 8, iters=200, device="cpu")
    assert float(info["grad_norms"][-1]) < 1e-10
    assert e - E1 < 1e-5
    assert float(iMPS([AL]).correlation_length()) > 20.0


def test_vumps_float32_converges():
    """Regression: the Lanczos breakdown threshold is dtype-aware.  A
    float32 h (numpy) and a complex64 seeded start run in complex64 and
    converge: |e - exact| < 5e-4, gradient < 1e-4."""
    h = np.asarray(tfim(1.0).to_matrix().real, np.float32)
    A0 = random_tensor(torch.Generator().manual_seed(0), 2, 4, dtype=torch.complex64, device="cpu")
    AL, C, e, info = ttd.vumps_ground_state(h, 4, iters=150, A0=A0)
    assert AL.dtype == torch.complex64
    assert abs(e - E1) < 5e-4
    assert float(info["grad_norms"][-1]) < 1e-4
    AL32, _, _, _ = ttd.vumps_ground_state(h, 4, iters=1, device="cpu")
    assert AL32.dtype == torch.complex64  # a float32 h alone means complex64


def test_vumps_converged_wrapper_stops_at_knee():
    """Chunks of 60 warm-restarted iterations stop at the first chunk with
    grad <= 1e-6; iters_to_knee indexes the knee in the concatenated
    history; the state is as good as the fixed window's."""
    AL, C, e, info = ttd.vumps_ground_state_converged(tfim(1.0).to_matrix(), 4, tol=1e-6, chunk_iters=60,
                                                      max_iters=300, device="cpu")
    gs, knee = info["grad_norms"], info["iters_to_knee"]
    assert knee > 0, gs[-1]
    assert gs[knee - 1] <= 1e-6 and np.all(gs[: knee - 1] > 1e-6)
    assert info["total_iters"] == 60 * ((knee + 59) // 60) == gs.shape[0]
    assert E1 - 1e-9 <= e < E1 + 1e-4


def test_vumps_converged_reports_minus_one_above_tol():
    """An unreachable tol returns iters_to_knee = -1 after max_iters."""
    _, _, _, info = ttd.vumps_ground_state_converged(tfim(1.0).to_matrix(), 4, tol=1e-30, chunk_iters=25,
                                                     max_iters=50, device="cpu")
    assert info["iters_to_knee"] == -1 and info["total_iters"] == 50


def test_variance_certificate(d4_runs):
    """variance_certificate: JAX's on the same state (1e-10); < 1e-3 on a
    converged D = 4 state (the truncation), > 1e-2 on a random one, and
    energy_variance_density at the true fixed point (1e-8)."""
    h = tfim(1.0).to_matrix()
    _, (ALj, _, _, _), (AL, _, _, _) = d4_runs
    var = ttd.variance_certificate(AL, h)
    assert abs(var - jtd.variance_certificate(ALj, h)) < 1e-10
    assert 0.0 <= var < 1e-3
    ALr, _, _ = left_orthogonalise(torch.from_numpy(_random_A(3, 4)))
    var_r = ttd.variance_certificate(ALr, h)
    assert var_r > 1e-2
    _, r = ttr.right_fixed_point(ALr, ALr)
    r = (r + r.mH) / 2
    assert abs(var_r - float(ttd.energy_variance_density(ALr, r / torch.trace(r), torch.from_numpy(h)))) < 1e-8


def test_gmres_environments_match_dense():
    """At D = 8 the GMRES environments equal the dense ones (1e-10) and the
    energy density (1e-12)."""
    AL, AR, C = ttd.mixed_gauge(torch.from_numpy(_random_A(4, 8)))
    h = torch.from_numpy(tfim(1.0).to_matrix())
    HLd, HRd, ed = ttd.hamiltonian_environments(AL, AR, C, h, env_solver="dense")
    HLg, HRg, eg = ttd.hamiltonian_environments(AL, AR, C, h, env_solver="gmres")
    assert float((HLd - HLg).abs().max()) < 1e-10
    assert float((HRd - HRg).abs().max()) < 1e-10
    assert abs(float(ed) - float(eg)) < 1e-12


def test_reported_energy_is_returned_states():
    """At a deliberately unconverged stop (D = 8, 12 iterations) the
    returned energy is the returned AL's true fixed-point energy (1e-12),
    above exact."""
    h = tfim(1.0).to_matrix()
    AL, C, e, _ = ttd.vumps_ground_state(h, 8, iters=12, device="cpu")
    assert abs(e - float(iMPS([AL]).energy(torch.from_numpy(h)))) < 1e-12
    assert e >= E1 - 1e-9


def test_cell2_matches_jax_and_the_single_site_energy():
    """Blocked TFIM at D = 4, 120 iterations from the same blocked A0 as
    JAX: the energy per site equals JAX's (1e-10), converged (gradient <
    1e-10), variational, within 1e-4 of exact."""
    A0 = _random_A(5, 4, d=4)
    h = tfim(1.0).to_matrix()
    AL, C, e, info = ttd.vumps_ground_state_cell2(h, 4, iters=120, A0=A0, device="cpu")
    _, _, ej, _ = jtd.vumps_ground_state_cell2(h, 4, iters=120, A0=A0)
    assert AL.shape == (4, 4, 4)
    assert abs(e - ej) < 1e-10
    assert float(info["grad_norms"][-1]) < 1e-10
    assert E1 - 1e-9 <= e < E1 + 1e-4


def test_split_cell_roundtrip_and_truncation():
    """split_cell of a converged blocked state: the exact split reassembles
    the cell (1e-12) and equals JAX's up to the SVD's column phases; the
    r-weighted truncation keeps the largest Schmidt values (JAX's, 1e-10)
    and its weighted error is the dropped weight (1e-8 relative)."""
    AL, _, _, _ = ttd.vumps_ground_state_cell2(tfim(1.0).to_matrix(), 4, iters=120, device="cpu")
    A1, A2, s = ttd.split_cell(AL)
    assert A1.shape == (2, 4, 8) and A2.shape == (2, 8, 4)
    np.testing.assert_allclose(to_np(torch.einsum("sim,tmj->stij", A1, A2).reshape(4, 4, 4)), to_np(AL),
                               atol=1e-12)
    np.testing.assert_allclose(to_np(s), np.asarray(jtd.split_cell(jnp.asarray(to_np(AL)))[2]), atol=1e-12)
    _, _, s_full = ttd.split_cell(AL, D_max=8)
    np.testing.assert_allclose(float(torch.sum(s_full ** 2)), 1.0, atol=1e-10)
    np.testing.assert_allclose(to_np(s_full), np.asarray(jtd.split_cell(jnp.asarray(to_np(AL)), D_max=8)[2]),
                               atol=1e-10)
    A1t, A2t, st = ttd.split_cell(AL, D_max=4)
    assert A1t.shape == (2, 4, 4) and st.shape == (4,)
    np.testing.assert_allclose(to_np(st), to_np(s_full[:4]), atol=1e-12)
    rec4 = torch.einsum("sim,tmj->stij", A1t, A2t).reshape(AL.shape)
    F = _cholesky_psd(ttd._true_r(AL))
    err_w = float(torch.linalg.vector_norm((rec4 - AL) @ F))
    np.testing.assert_allclose(err_w, float(torch.sqrt(torch.sum(s_full[4:] ** 2))), rtol=1e-8)
