"""The energy-variance certificate of qmps_torch (mps/tdvp's
energy_variance_density, iMPS.energy_variance, sweep_variance_certificates)
against qmps_tpu's, at complex128 on the CPU.  Mirrors tests/test_variance.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import to_np
from qmps_torch.ham.hamiltonian import tfim
from qmps_torch.mps import tdvp as ttd
from qmps_torch.mps.imps import iMPS
from qmps_torch.parallel import sweep as tsw
from qmps_tpu.mps import tdvp as jtd
from qmps_tpu.mps import transfer as jtr
from qmps_tpu.mps.imps import iMPS as JiMPS
from qmps_tpu.mps.imps import left_orthogonalise as j_left_orthogonalise
from qmps_tpu.parallel import sweep as jsw


def _canonical_pair(seed, D):
    """(AL, r) numpy: JAX's random state, left-canonical, r its unit-trace
    right fixed point (tests/test_variance.py's pair)."""
    AL, _, _ = j_left_orthogonalise(JiMPS.random(jax.random.PRNGKey(seed), 2, D)[0])
    _, r = jtr.right_fixed_point(AL, AL)
    r = (r + r.conj().T) / 2
    return np.array(AL), np.array(r / jnp.trace(r))


@pytest.mark.parametrize("solver", ["dense", "gmres"])
def test_variance_density_matches_jax(solver):
    """Random D = 3 and D = 4 states, TFIM at g = 0.7 and 1.3: the port's
    variance equals JAX's with the same solver (1e-10), and the GMRES one
    the dense one (1e-8 relative, as JAX holds its own)."""
    for seed, D, g in [(0, 3, 0.7), (1, 3, 0.7), (7, 4, 1.3)]:
        AL, r = _canonical_pair(seed, D)
        h = tfim(g).to_matrix()
        got = float(ttd.energy_variance_density(*(torch.from_numpy(x) for x in (AL, r, h)), env_solver=solver))
        want = float(jtd.energy_variance_density(jnp.asarray(AL), jnp.asarray(r), jnp.asarray(h),
                                                 env_solver=solver))
        assert abs(got - want) < 1e-10, (seed, got, want)
        dense = float(ttd.energy_variance_density(*(torch.from_numpy(x) for x in (AL, r, h))))
        assert abs(got - dense) < 1e-8 * max(1.0, abs(dense))


def test_batched_variance_equals_per_element():
    """A batch of three states and Hamiltonians gives each one's variance
    (1e-12), through both solvers."""
    pairs = [_canonical_pair(s, 3) for s in (2, 3, 4)]
    AL = torch.from_numpy(np.stack([p[0] for p in pairs]))
    r = torch.from_numpy(np.stack([p[1] for p in pairs]))
    h = tsw.tfim_matrix(torch.tensor([0.6, 1.0, 1.4], dtype=torch.float64)).to(AL.dtype)
    for solver in ("dense", "gmres"):
        vb = ttd.energy_variance_density(AL, r, h, env_solver=solver)
        for i in range(3):
            torch.testing.assert_close(vb[i], ttd.energy_variance_density(AL[i], r[i], h[i], env_solver=solver),
                                       atol=1e-12, rtol=0)


def test_eigenstate_has_zero_variance():
    """|000...> is an eigenstate of -ZZ, |+++...> of -XX: variance < 1e-12."""
    Z = np.diag([1.0, -1.0]) + 0j
    X = np.array([[0, 1], [1, 0]]) + 0j
    r = torch.eye(1, dtype=torch.complex128)
    up = torch.zeros((2, 1, 1), dtype=torch.complex128)
    up[0, 0, 0] = 1.0
    assert abs(float(ttd.energy_variance_density(up, r, torch.from_numpy(-np.kron(Z, Z))))) < 1e-12
    plus = torch.full((2, 1, 1), 1 / np.sqrt(2), dtype=torch.complex128)
    assert abs(float(ttd.energy_variance_density(plus, r, torch.from_numpy(-np.kron(X, X))))) < 1e-12


def test_variance_positive_for_non_eigenstate():
    AL, r = _canonical_pair(3, 2)
    h = torch.from_numpy(tfim(1.0).to_matrix())
    assert float(ttd.energy_variance_density(torch.from_numpy(AL), torch.from_numpy(r), h)) > 1e-3


@pytest.mark.parametrize("solver", ["dense", "gmres"])
def test_imps_wrapper_matches_jax(solver):
    """iMPS.energy_variance of JAX's random D = 3 state equals JAX's
    (1e-10)."""
    A = np.asarray(JiMPS.random(jax.random.PRNGKey(11), 2, 3)[0])
    h = tfim(0.9).to_matrix()
    got = float(iMPS([torch.from_numpy(A)]).energy_variance(torch.from_numpy(h), env_solver=solver))
    want = float(JiMPS([jnp.asarray(A)]).energy_variance(jnp.asarray(h), env_solver=solver))
    assert abs(got - want) < 1e-10


def test_sweep_certificates_match_jax():
    """sweep_variance_certificates on the same As and rs (the port's D = 4
    sweep) equals JAX's (1e-8), chunked or not."""
    gs = np.linspace(0.4, 1.6, 6)
    _, As, rs = tsw.sweep_ground_states_stiefel(torch.from_numpy(gs), D=4, steps=60)
    var = to_np(tsw.sweep_variance_certificates(torch.from_numpy(gs), As, rs))
    var_j = np.asarray(jsw.sweep_variance_certificates(jnp.asarray(gs), jnp.asarray(to_np(As)),
                                                       jnp.asarray(to_np(rs))))
    np.testing.assert_allclose(var, var_j, atol=1e-8)
    chunked = to_np(tsw.sweep_variance_certificates(torch.from_numpy(gs), As, rs, point_chunk=4))
    np.testing.assert_allclose(chunked, var, atol=1e-12)


def test_sweep_certificates_flag_unconverged_points():
    """Converged sweep points carry small variances (> -1e-9, < 5e-2), a
    3-step sweep's are 5x larger at the median, and the batched GMRES
    certificate equals the single-point dense one (1e-6 relative)
    (tests/test_variance.py:114-148)."""
    gs = torch.linspace(0.4, 1.6, 8, dtype=torch.float64)
    _, As, rs = tsw.sweep_ground_states_stiefel(gs, D=4, steps=250)
    var = to_np(tsw.sweep_variance_certificates(gs, As, rs))
    assert var.shape == (8,)
    assert np.all(var > -1e-9)
    assert np.max(var) < 5e-2, var
    _, As0, rs0 = tsw.sweep_ground_states_stiefel(gs, D=4, steps=3)
    var0 = to_np(tsw.sweep_variance_certificates(gs, As0, rs0))
    assert np.median(var0) > 5 * np.median(var), (var0, var)

    i = 3
    A, r = As[i], rs[i]
    for _ in range(60):
        r = torch.einsum("sai,ij,sbj->ab", A, r, A.conj())
        r = (r + r.mH) / 2
        r = r / torch.linalg.matrix_norm(r)
    r = r / torch.trace(r)
    dense = float(ttd.energy_variance_density(A, r, tsw.tfim_matrix(gs[i]).to(A.dtype), env_solver="dense"))
    assert abs(dense - float(var[i])) < 1e-6 * max(1.0, abs(dense))
