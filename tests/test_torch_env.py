"""qmps_torch's gen-1 environments (env.exact, the gen-1 half of
env.variational, algorithms.represent) against qmps_tpu at complex128:
exact and power-method environments, the tomography and trace-distance
objectives, the variational environment and the variational mixed fixed
point from JAX's own starts, tests/test_env.py:34-75 on the port, and
tests/test_ensemble_validation.py::test_gen1_mixed_env_ensemble's anchors
(slow, as there)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import to_np
from qmps_torch.algorithms.represent import RepresentMPS
from qmps_torch.core.linalg import random_unitary
from qmps_torch.embed.unitaries import environment_from_unitary, unitary_to_tensor
from qmps_torch.env import exact as te
from qmps_torch.env import variational as tv
from qmps_torch.mps import transfer as tr
from qmps_tpu.core.linalg import random_unitary as jrandom_unitary
from qmps_tpu.env import exact as je
from qmps_tpu.env import variational as jv


@pytest.fixture(scope="module")
def U():
    """JAX's test unitary (tests/test_env.py:29-31), as numpy."""
    return np.array(jrandom_unitary(jax.random.PRNGKey(5), 4))


def test_exact_environments_match_jax(U):
    """C, V and the power-method r (20 and 60 steps) to 1e-12."""
    Ut = torch.from_numpy(U)
    np.testing.assert_allclose(to_np(te.get_env_exact_C(Ut)), np.asarray(je.get_env_exact_C(jnp.asarray(U))),
                               rtol=0, atol=1e-12)
    np.testing.assert_allclose(to_np(te.get_env_exact(Ut)), np.asarray(je.get_env_exact(jnp.asarray(U))),
                               rtol=0, atol=1e-12)
    for k in (20, 60):
        np.testing.assert_allclose(to_np(te.power_method_env(Ut, k)),
                                   np.asarray(je.power_method_env(jnp.asarray(U), k)), rtol=0, atol=1e-12)


def test_circuit_objectives_match_jax(U):
    """``state_circuit_psi`` (1 and 2 physical qubits), the reduced density
    matrix, the bloch vector, and the tomography and trace-distance
    objectives at a random V, to 1e-12."""
    V = np.array(jrandom_unitary(jax.random.PRNGKey(9), 4))
    Ut, Vt = torch.from_numpy(U), torch.from_numpy(V)
    for n_phys in (1, 2):
        np.testing.assert_allclose(to_np(tv.state_circuit_psi(Ut, Vt, n_phys)),
                                   np.asarray(jv.state_circuit_psi(jnp.asarray(U), jnp.asarray(V), n_phys)),
                                   rtol=0, atol=1e-12)
    psi = jv.state_circuit_psi(jnp.asarray(U), jnp.asarray(V), 2)
    for keep in ([0], [1, 3], [2]):
        rho_j = jv.reduced_density_matrix(psi, keep, 4)
        rho_t = tv.reduced_density_matrix(torch.from_numpy(np.array(psi)), keep, 4)
        np.testing.assert_allclose(to_np(rho_t), np.asarray(rho_j), rtol=0, atol=1e-12)
        if len(keep) == 1:
            np.testing.assert_allclose(to_np(tv.bloch_vector(rho_t)), np.asarray(jv.bloch_vector(rho_j)),
                                       rtol=0, atol=1e-12)
    for fj, ft in ((jv.tomography_env_objective, tv.tomography_env_objective),
                   (jv.trace_distance_objective, tv.trace_distance_objective)):
        np.testing.assert_allclose(ft(Ut, Vt).item(), float(fj(jnp.asarray(U), jnp.asarray(V))), rtol=0, atol=1e-12)


def test_variational_env_matches_jax_from_its_start(U):
    """``get_env_variational``'s adam from JAX's normals (PRNGKey(0)), 200
    steps: V and the loss to 1e-10."""
    v0 = np.array(jax.random.normal(jax.random.PRNGKey(0), (8,)))
    Vj, lj = jv.get_env_variational(jnp.asarray(U), steps=200)
    Vt, lt = tv._get_env_variational_from(torch.from_numpy(U), torch.from_numpy(v0), 200, 5e-2)
    np.testing.assert_allclose(to_np(Vt), np.asarray(Vj), rtol=0, atol=1e-10)
    np.testing.assert_allclose(lt.item(), float(lj), rtol=0, atol=1e-10)


def _mixed_pair(seed):
    """A left-canonical A and B = the left-canonical A + DT dA/dt under
    ZZ + (XI + IX) / 2, as tests/test_ensemble_validation.py builds them (the
    port's canonical forms and dA_dt, which PR 11 holds to JAX's)."""
    from qmps_torch.mps.imps import iMPS, random_tensor

    X, Z, I2 = np.array([[0, 1], [1, 0]]), np.diag([1, -1]), np.eye(2)
    H = torch.from_numpy(np.kron(Z, Z) + np.kron(X, I2) / 2 + np.kron(I2, X) / 2).to(torch.complex128)
    g = torch.Generator().manual_seed(seed)
    A = iMPS([random_tensor(g, 2, 2, device="cpu")]).left_canonicalise()[0]
    B = iMPS([A + 1e-2 * iMPS([A]).dA_dt(H)]).left_canonicalise()[0]
    return A, B


def _jax_starts(key, n, n_starts=8):
    rand = jax.random.normal(key, (n_starts - 1, 2 + 2 * n)).at[:, 0].set(1.0).at[:, 1].set(0.0)
    return torch.from_numpy(np.array(rand))


def test_variational_fixed_point_matches_jax_from_its_starts():
    """From JAX's random starts, 300 steps: lam and the residual of the
    chosen start equal JAX's to 1e-10, r to 1e-10 up to its global phase
    (a direction of zero gradient, held within 1e-8), and a batch of two
    pairs equals the pairs one by one."""
    pairs = [_mixed_pair(s) for s in (0, 1)]
    outs = []
    for k, (A, B) in enumerate(pairs):
        key = jax.random.PRNGKey(10 + k)
        lam_j, r_j, res_j = jv.variational_fixed_point(jnp.asarray(to_np(A)), jnp.asarray(to_np(B)), steps=300,
                                                        key=key)
        rand = _jax_starts(key, 4)
        lam, r, res = tv._variational_fixed_point_from(A, B, rand, 300, 1e-1)
        np.testing.assert_allclose(lam.item(), complex(lam_j), rtol=0, atol=1e-10)
        np.testing.assert_allclose(res.item(), float(res_j), rtol=0, atol=1e-10)
        _assert_same_up_to_phase(to_np(r), np.asarray(r_j))
        outs.append((lam, r, res, rand))
    As, Bs = (torch.stack(x) for x in zip(*pairs))
    lam, r, res = tv._variational_fixed_point_from(As, Bs, torch.stack([o[3] for o in outs]), 300, 1e-1)
    for k, (l1, r1, s1, _) in enumerate(outs):
        np.testing.assert_allclose(lam[k].item(), l1.item(), rtol=0, atol=1e-10)
        np.testing.assert_allclose(res[k].item(), s1.item(), rtol=0, atol=1e-10)
        _assert_same_up_to_phase(to_np(r[k]), to_np(r1))


def _assert_same_up_to_phase(got, want):
    """r's global phase leaves the residual unchanged: its gradient is
    rounding, which adam turns into steps (~5e-10 apart after 300).  The
    rest to 1e-10, the phase within 1e-8."""
    ph = np.vdot(got, want)
    print("r's phase apart:", abs(np.angle(ph)))
    np.testing.assert_allclose(got * ph / abs(ph), want, rtol=0, atol=1e-10)
    assert abs(np.angle(ph)) < 1e-8


# -- tests/test_env.py:34-75, on the port --------------------------------------


def test_env_unitary_reproduces_fixed_point(U):
    Ut = torch.from_numpy(U)
    C = environment_from_unitary(te.get_env_exact(Ut))
    r = C @ C.mH
    A = unitary_to_tensor(Ut)
    np.testing.assert_allclose(to_np(tr.right_matvec(A, A, r)), to_np(r), atol=1e-9)


def test_exact_env_zeroes_the_objectives(U):
    Ut = torch.from_numpy(U)
    V = te.get_env_exact(Ut)
    assert tv.tomography_env_objective(Ut, V).item() < 1e-9
    assert tv.trace_distance_objective(Ut, V).item() < 1e-9


def test_power_method_converges(U):
    A = unitary_to_tensor(torch.from_numpy(U))
    _, r = tr.right_fixed_point(A, A)
    r = (r + r.mH) / 2
    r = r / r.diagonal().sum()
    np.testing.assert_allclose(to_np(te.power_method_env(torch.from_numpy(U), 60)), to_np(r), atol=1e-8)


def test_variational_env_matches_exact(U):
    V = RepresentMPS(torch.from_numpy(U), "variational", steps=800).get_env()
    assert tv.tomography_env_objective(torch.from_numpy(U), V).item() < 1e-8


def test_represent_strategies_api(U):
    for strategy in ("exact", "power"):
        V = to_np(RepresentMPS(torch.from_numpy(U), strategy).get_env())
        assert np.linalg.norm(V.conj().T @ V - np.eye(4)) < 1e-9
    with pytest.raises(ValueError):
        RepresentMPS(torch.from_numpy(U), "nope").get_env()


def test_float32_exact_environment():
    """In float32 the Cholesky takes 32 eps of jitter (1e-14 is below the
    type's resolution): C C^dag is the fixed point to float32 rounding."""
    U = random_unitary(torch.Generator().manual_seed(3), 4, dtype=torch.complex64)
    C = te.get_env_exact_C(U)
    A = unitary_to_tensor(U.to(torch.complex128))
    _, r = tr.right_fixed_point(A, A)
    r = (r + r.mH) / 2
    r = r / r.diagonal().sum()
    assert C.dtype == torch.complex64
    np.testing.assert_allclose(to_np((C @ C.mH).to(torch.complex128)), to_np(r), atol=2e-5)


@pytest.mark.slow
def test_gen1_mixed_env_ensemble():
    """100 TDVP-step pairs, one batch: the variational eigensolve recovers
    the exact mixed fixed point; >= 95% of instances converge, and over the
    converged set mean |d lam| < 1e-4 and the environment's Frobenius
    error < 1e-3 (tests/test_ensemble_validation.py:74-106)."""
    pairs = [_mixed_pair(100 + s) for s in range(100)]
    As, Bs = (torch.stack(x) for x in zip(*pairs))
    lam, rv, res = tv.variational_fixed_point(As, Bs, generator=torch.Generator().manual_seed(7))
    e_ex, r_ex = tr.right_fixed_point(As, Bs)
    ph = (rv.conj() * r_ex).sum((-2, -1))
    ph = ph / ph.abs()
    d_lam = to_np((lam.abs() - e_ex.abs()).abs())
    d_env = to_np(torch.linalg.matrix_norm(rv - ph.conj()[:, None, None] * r_ex))
    conv = to_np(res) < 1e-8
    assert conv.mean() >= 0.95, conv.mean()
    assert d_lam[conv].mean() < 1e-4, d_lam[conv].mean()
    assert d_env[conv].mean() < 1e-3, d_env[conv].mean()
