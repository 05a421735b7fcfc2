"""qmps_torch.optim.riemann and the recycled fixed points of
qmps_torch.mps.transfer against qmps_tpu's, at complex128 on the CPU.
Mirrors tests/test_riemann.py, with its sizes and tolerances.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import to_np
from qmps_torch.ham.exact import tfim_gs_energy_f64
from qmps_torch.ham.hamiltonian import tfim
from qmps_torch.mps import transfer as ttr
from qmps_torch.mps.imps import iMPS
from qmps_torch.optim import riemann as tri
from qmps_tpu.mps.imps import iMPS as JiMPS
from qmps_tpu.optim import riemann as jri


def _isometry(key, D):
    """(2D, D) isometry from JAX normals (tests/test_riemann.py's start)."""
    X = jax.random.normal(key, (2 * D, D)) + 1j * jax.random.normal(jax.random.fold_in(key, 7), (2 * D, D))
    return np.array(jnp.linalg.qr(X)[0])


def test_stiefel_minimize_stays_on_manifold(key):
    """200 steps at lr 0.2 from JAX's start: V^dag V = I to 1e-9, the loss
    falls, and the history equals JAX's (1e-10; its first step would show
    a second conjugation of the gradient)."""
    D = 3
    X = jax.random.normal(key, (6, D)) + 1j * jax.random.normal(jax.random.fold_in(key, 1), (6, D))
    V0 = np.array(jnp.linalg.qr(X)[0])
    target = np.eye(6)[:, :D]

    V, hist = tri.stiefel_minimize(lambda V: (V - torch.from_numpy(target)).abs().pow(2).sum(),
                                   torch.from_numpy(V0), steps=200, lr=0.2)
    np.testing.assert_allclose(to_np(V.mH @ V), np.eye(D), atol=1e-9)
    assert float(hist[-1]) < float(hist[0]) and hist.shape == (201,)
    _, hist_j = jri.stiefel_minimize(lambda V: jnp.sum(jnp.abs(V - target) ** 2), jnp.asarray(V0),
                                     steps=200, lr=0.2)
    np.testing.assert_allclose(to_np(hist), np.asarray(hist_j), atol=1e-10)


def test_riemannian_ground_state_d2():
    """D = 2, 300 steps: within 1e-3 of the exact energy (the D = 2
    optimum), left-canonical to 1e-10, and within 1e-6 of JAX's energy
    from its own start."""
    h = tfim(1.0).to_matrix()
    A, e, _ = tri.ground_state_riemannian(h, 2, steps=300, lr=0.08, device="cpu")
    assert e - float(tfim_gs_energy_f64(1.0)) < 1e-3
    A = to_np(A)
    g = sum(A[s].conj().T @ A[s] for s in range(2))
    np.testing.assert_allclose(g, np.eye(2), atol=1e-10)
    _, e_j, _ = jri.ground_state_riemannian(jnp.asarray(h), 2, steps=300, lr=0.08)
    assert abs(e - e_j) < 1e-6


def test_recycled_descent_matches_jax_from_the_same_start(key):
    """The recycled program from JAX's own start isometry (its key split),
    D = 3, 40 steps: every history entry, the boosted final one included,
    equals JAX's (1e-10), and so does the returned isometry."""
    D, steps = 3, 40
    h = tfim(0.8).to_matrix()
    k1, k2 = jax.random.split(key)
    V0 = jnp.linalg.qr(jax.lax.complex(jax.random.normal(k1, (2 * D, D)), jax.random.normal(k2, (2 * D, D))))[0]
    V_j, hist_j = jri._recycled_program(D, steps, 0.08, 0.9, 24)(key, jnp.asarray(h.real), jnp.asarray(h.imag))
    V_t, hist_t = tri._recycled_descent(torch.from_numpy(np.asarray(V0)), torch.from_numpy(h), D, steps, 0.08,
                                        0.9, 24)
    np.testing.assert_allclose(to_np(hist_t), np.asarray(hist_j), atol=1e-10)
    np.testing.assert_allclose(to_np(V_t), np.asarray(V_j), atol=1e-10)


def test_reported_energy_is_returned_states_energy():
    """hist has steps + 1 entries, the last is the returned energy, and the
    returned tensor realizes it (200 eps)."""
    h = tfim(1.0).to_matrix()
    A, e, hist = tri.ground_state_riemannian(h, 2, steps=60, lr=0.08, device="cpu")
    assert hist.shape == (61,) and float(hist[-1]) == e
    e_of_A = float(iMPS([A]).energy(torch.from_numpy(h)))
    assert abs(e_of_A - e) < 200 * np.finfo(np.float64).eps


def test_cold_solver_knobs_raise_with_recycle():
    h = tfim(1.0).to_matrix()
    for kw in ({"dense_env_max_D": 2}, {"power_iters": 50}):
        with pytest.raises(ValueError, match="recycle=False"):
            tri.ground_state_riemannian(h, 2, steps=1, device="cpu", **kw)


def test_cold_krylov_path_matches_cold_dense():
    """recycle=False with dense_env_max_D below D runs the matvec Krylov
    environment (Arnoldi forward, GMRES adjoint): 12 steps at D = 3 give
    the dense path's history (1e-8)."""
    h = tfim(1.1).to_matrix()
    runs = [tri.ground_state_riemannian(h, 3, steps=12, recycle=False, dense_env_max_D=m, device="cpu",
                                        generator=torch.Generator().manual_seed(4))[2] for m in (2, 8)]
    np.testing.assert_allclose(to_np(runs[0]), to_np(runs[1]), atol=1e-8)


def test_warm_eigpair_matches_dense(key):
    """right_eigpair_warm from I with 200 iterations gives the dense
    eigenvalue (1e-10) and its projector (1e-9), and JAX's pair (1e-12)."""
    A = np.asarray(JiMPS.random(key, 2, 5)[0])
    At = torch.from_numpy(A)
    lam_d, r_d = ttr.right_fixed_point(At, At, dense=True)
    lam_w, r_w = ttr.right_eigpair_warm(At, At, torch.eye(5, dtype=At.dtype), 200)
    assert abs(complex(lam_w) - complex(lam_d)) < 1e-10
    rw, rd = to_np(r_w).reshape(-1), to_np(r_d).reshape(-1)
    np.testing.assert_allclose(np.outer(rw, rw.conj()), np.outer(rd, rd.conj()) / np.vdot(rd, rd), atol=1e-9)
    from qmps_tpu.mps.transfer import right_eigpair_warm

    lam_j, r_j = right_eigpair_warm(jnp.asarray(A), jnp.asarray(A), jnp.eye(5, dtype=A.dtype), 200)
    assert abs(complex(lam_w) - complex(lam_j)) < 1e-12
    np.testing.assert_allclose(rw, np.asarray(r_j).reshape(-1), atol=1e-12)


def _warm_value_and_grad(V, h, D, bwd, iters=300):
    Vt = torch.from_numpy(V).requires_grad_()
    r0 = torch.eye(D, dtype=Vt.dtype) / np.sqrt(D)
    e, _ = tri.isometry_energy_warm(Vt, torch.from_numpy(h), D, r0, iters, bwd)
    e.backward()
    return e.item(), to_np(Vt.grad)


@pytest.mark.parametrize("bwd", ["lu", "gmres"])
def test_warm_energy_gradient_matches_cold(key, bwd):
    """Both branches of the implicit c-gauge adjoint, forced, give the cold
    dense gradient (1e-7) and conj(jax.grad) of JAX's warm energy (1e-7),
    with the cold energy (1e-10), at D = 4 (f64)."""
    D = 4
    h = tfim(1.2).to_matrix()
    V = _isometry(key, D)
    Vc = torch.from_numpy(V).requires_grad_()
    e_cold = tri.isometry_energy(Vc, torch.from_numpy(h), D, True)
    e_cold.backward()
    e_warm, g_warm = _warm_value_and_grad(V, h, D, bwd)
    assert abs(e_warm - e_cold.item()) < 1e-10
    np.testing.assert_allclose(g_warm, to_np(Vc.grad), atol=1e-7)
    r0 = jnp.eye(D, dtype=V.dtype) / np.sqrt(D)
    g_j = jax.grad(lambda V: jri.isometry_energy_warm(V, jnp.asarray(h), D, r0, 300, bwd)[0])(jnp.asarray(V))
    np.testing.assert_allclose(g_warm, np.conj(np.asarray(g_j)), atol=1e-7)


def test_unroll_gradient_matches_implicit(key):
    """bwd="unroll" (plain autograd through 300 warm iterations) gives the
    implicit adjoint's energy (1e-12) and gradient (1e-7)."""
    D = 4
    h = tfim(1.2).to_matrix()
    V = _isometry(key, D)
    e_imp, g_imp = _warm_value_and_grad(V, h, D, "auto")
    e_unr, g_unr = _warm_value_and_grad(V, h, D, "unroll")
    assert abs(e_unr - e_imp) < 1e-12
    np.testing.assert_allclose(g_unr, g_imp, atol=1e-7)


@pytest.mark.parametrize("bwd", ["lu", "gmres"])
def test_warm_adjoint_gradcheck(key, bwd):
    """torch.autograd.gradcheck at complex128, D = 2: the warm eigenvalue
    in A and B separately, and the warm energy in V (A and B move together,
    so r stays hermitian and the c-gauge derivative is the true one)."""
    rng = np.random.default_rng(11)
    A = torch.from_numpy(rng.normal(size=(2, 2, 2)) + 1j * rng.normal(size=(2, 2, 2))).requires_grad_()
    B = (A.detach() + 0.1 * torch.from_numpy(rng.normal(size=(2, 2, 2)) + 0j)).requires_grad_()
    r0 = torch.eye(2, dtype=A.dtype)
    assert torch.autograd.gradcheck(lambda A, B: ttr.right_eigpair_warm(A, B, r0, 100, bwd)[0], (A, B),
                                   fast_mode=True)
    V = torch.from_numpy(_isometry(key, 2)).requires_grad_()
    h = torch.from_numpy(tfim(0.9).to_matrix())
    assert torch.autograd.gradcheck(lambda V: tri.isometry_energy_warm(V, h, 2, r0, 100, bwd)[0], (V,),
                                   fast_mode=True)


def test_warm_start_vector_gets_zero_cotangent(key):
    A = torch.from_numpy(np.asarray(JiMPS.random(key, 2, 3)[0]))
    r0 = torch.eye(3, dtype=A.dtype).requires_grad_()
    lam, _ = ttr.right_eigpair_warm(A, A, r0, 100)
    (g,) = torch.autograd.grad(lam.abs(), r0)
    assert torch.equal(g, torch.zeros_like(r0))


def test_recycled_matches_cold_optimizer():
    """recycle=True reaches the cold per-step solver's energy (2e-4) at
    D = 4, 250 steps, within [0, 1e-3) of the exact integral, and returns
    a left-canonical tensor (1e-10)."""
    h = tfim(1.0).to_matrix()
    e_exact = float(tfim_gs_energy_f64(1.0))
    A_r, e_r, _ = tri.ground_state_riemannian(h, 4, steps=250, lr=0.08, recycle=True, device="cpu")
    _, e_c, _ = tri.ground_state_riemannian(h, 4, steps=250, lr=0.08, recycle=False, device="cpu")
    assert 0 <= e_r - e_exact < 1e-3
    assert abs(e_r - e_c) < 2e-4
    A = to_np(A_r)
    np.testing.assert_allclose(sum(A[s].conj().T @ A[s] for s in range(2)), np.eye(4), atol=1e-10)
