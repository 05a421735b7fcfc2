"""The MPO layer of qmps_torch (mps/mpo: Schur-form MPOs, block
environments, MPO-VUMPS and MPO-TDVP) against qmps_tpu's at complex128 on
the CPU, and the checks of tests/test_mpo.py: every MPO quantity against
the two-site path of the same model, window sums and exact oracles.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import to_np
from qmps_torch.algorithms.evolve import MPSTimeEvolve
from qmps_torch.ham.classical_baselines import nnn_ising_ed_energy
from qmps_torch.ham.exact import tfim_gs_energy_f64
from qmps_torch.ham.hamiltonian import heisenberg, tfim, xxz
from qmps_torch.mps import mpo as tm
from qmps_torch.mps import tdvp as ttd
from qmps_torch.mps.imps import iMPS
from qmps_torch.utils.convert import from_mixed_gauge, from_mpo
from qmps_tpu.mps import mpo as jm
from qmps_tpu.mps import tdvp as jtd

X = np.array([[0.0, 1.0], [1.0, 0.0]])
Z = np.diag([1.0, -1.0])
I2 = np.eye(2)


def _random_A(seed, D=4, d=2):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((d, D, D)) + 1j * rng.standard_normal((d, D, D))


def _mixed(seed, D=4):
    """(numpy triple from JAX's mixed gauge, the port's tensors of it)."""
    mj = tuple(np.asarray(x) for x in jtd.mixed_gauge(jnp.asarray(_random_A(seed, D))))
    return mj, from_mixed_gauge(mj)


MODELS = {
    "tfim": (lambda m: m.mpo_tfim(0.7)),
    "xxz": (lambda m: m.mpo_xxz(1.3)),
    "nnn": (lambda m: m.mpo_nnn_ising(g=0.5, J2=0.2)),
    "exp_decay": (lambda m: m.mpo_exp_decay(-Z, Z, 0.4, field=-0.8 * X)),
    "two_site": (lambda m: m.mpo_from_two_site(tfim(0.8).to_matrix())),
}


@pytest.mark.parametrize("name", sorted(MODELS))
def test_models_and_windows_match_jax(name):
    """Each model's W equals JAX's; MPO.matrix(3) too, and converting
    JAX's MPO (utils.convert.from_mpo) gives the same W (exact)."""
    mt, mj = MODELS[name](tm), MODELS[name](jm)
    np.testing.assert_array_equal(mt.W, mj.W)
    np.testing.assert_array_equal(mt.matrix(3), mj.matrix(3))
    np.testing.assert_array_equal(from_mpo(mj).W, mj.W)


def test_window_matrix_tfim_and_nnn():
    """MPO.matrix(3) equals the explicit open-boundary sums (1e-14); the
    J2 string crosses one intermediate site."""
    def field(g):
        return g * (np.kron(np.kron(X, I2), I2) + np.kron(I2, np.kron(X, I2)) + np.kron(np.kron(I2, I2), X))

    zz = np.kron(np.kron(Z, Z), I2) + np.kron(I2, np.kron(Z, Z))
    assert np.abs(tm.mpo_tfim(0.7).matrix(3) - (-zz - field(0.7))).max() < 1e-14
    ref = -zz - 0.4 * np.kron(np.kron(Z, I2), Z) - field(0.3)
    assert np.abs(tm.mpo_nnn_ising(g=0.3, J2=0.4).matrix(3) - ref).max() < 1e-14


def test_window_matrix_exp_decay():
    """The exp-decay window sums lam^(j-i-1) op_l op_r over placements
    (1e-13); with no string ending inside a window of one site it is the
    zero operator."""
    lam = 0.37

    def emb(op, i, n=4):
        out = np.eye(1)
        for j in range(n):
            out = np.kron(out, op if j == i else I2)
        return out

    ref = sum(lam ** (j - i - 1) * (-emb(Z, i) @ emb(Z, j)) for i in range(4) for j in range(i + 1, 4))
    assert np.abs(tm.mpo_exp_decay(-Z, Z, lam).matrix(4) - ref).max() < 1e-13
    H1 = tm.mpo_exp_decay(-Z, Z, 0.4).matrix(1)
    assert H1.shape == (2, 2) and np.abs(H1).max() == 0.0


def test_schur_form_validation():
    """A lower-triangular entry, non-identity corners, a chi = 1 tensor
    and a non-decaying interior block (spectral radius 1) are refused; a
    decaying one is fine."""
    W = np.zeros((3, 3, 2, 2), complex)
    W[0, 0] = W[2, 2] = I2
    W[1, 0] = Z
    with pytest.raises(ValueError):
        tm.MPO(W)
    with pytest.raises(ValueError):
        tm.MPO(np.zeros((3, 3, 2, 2)))
    with pytest.raises(ValueError, match="chi >= 2"):
        tm.MPO(np.eye(2)[None, None])
    W[1, 0] = 0
    W[0, 1] = W[1, 2] = Z
    W[1, 1] = I2
    with pytest.raises(ValueError, match="spectral"):
        tm.MPO(W)
    W[1, 1] = 0.9 * I2
    assert tm.MPO(W).chi == 3
    with pytest.raises(ValueError):
        tm.mpo_exp_decay(-Z, Z, 1.0)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_environments_and_energy_match_jax(name):
    """mpo_environments (Ls, Rs, e) and energy_mpo on JAX's mixed gauge of
    a random D = 4 state equal JAX's (1e-10)."""
    mj_state, (AL, AR, C) = _mixed(2)
    mt, mj = MODELS[name](tm), MODELS[name](jm)
    got = tm.mpo_environments(AL, AR, C, mt)
    want = jm.mpo_environments(*(jnp.asarray(x) for x in mj_state), mj)
    for g, w in zip(got, want):
        np.testing.assert_allclose(to_np(g), np.asarray(w), atol=1e-10)
    e = float(tm.energy_mpo(AL, C, mt))
    assert abs(e - float(jm.energy_mpo(jnp.asarray(mj_state[0]), jnp.asarray(mj_state[2]), mj))) < 1e-10
    assert abs(e - float(got[2])) < 1e-12


@pytest.mark.parametrize("seed", [0, 3, 7])
def test_tfim_energy_identity(seed):
    """energy_mpo(mpo_tfim(-g)) equals the two-site energy_density (1e-12):
    ham.tfim carries +g X, the textbook MPO -g X."""
    _, (AL, _, C) = _mixed(seed)
    e2 = float(ttd.energy_density(AL, C, torch.from_numpy(tfim(0.7).to_matrix())))
    assert abs(e2 - float(tm.energy_mpo(AL, C, tm.mpo_tfim(-0.7)))) < 1e-12


def test_xxz_and_heisenberg_energy_identities():
    """XXZ's closed-form MPO and its SVD MPO, and Heisenberg's, give the
    two-site energy (1e-12)."""
    _, (AL, _, C) = _mixed(5)
    h = xxz(1.3).to_matrix()
    e2 = float(ttd.energy_density(AL, C, torch.from_numpy(h)))
    assert abs(e2 - float(tm.energy_mpo(AL, C, tm.mpo_xxz(1.3)))) < 1e-12
    assert abs(e2 - float(tm.energy_mpo(AL, C, tm.mpo_from_two_site(h)))) < 1e-12
    _, (AL, _, C) = _mixed(9, D=3)
    eh = float(ttd.energy_density(AL, C, torch.from_numpy(heisenberg(1.0).to_matrix())))
    assert abs(eh - float(tm.energy_mpo(AL, C, tm.mpo_heisenberg(1.0)))) < 1e-12


def test_exp_decay_energy_against_correlator_sum():
    """The interior geometric-sum solve against a brute-force tail:
    e = sum_k lam^(k-1) <-Z_0 Z_k> over 120 sites of connected correlators
    plus the disconnected geometric tail (1e-10)."""
    lam = 0.45
    AL, _, C = ttd.mixed_gauge(torch.from_numpy(_random_A(11)))
    e = float(tm.energy_mpo(AL, C, tm.mpo_exp_decay(-Z, Z, lam)))
    psi = iMPS([AL])
    Zt = torch.from_numpy(Z + 0j)
    Cr = to_np(psi.correlator(-Zt, Zt, max_dist=120))
    tail = float(psi.E(-Zt).real) * float(psi.E(Zt).real) / (1 - lam)
    assert abs(e - (float(np.sum(lam ** np.arange(120) * Cr)) + tail)) < 1e-10


def test_tangent_flow_matches_two_site_and_jax():
    """dAC_dC_dt_mpo(mpo_tfim(-0.7)) equals the two-site flow array for
    array (1e-10) and JAX's MPO flow (1e-10); dA_dt_mpo equals dA_dt at
    D = 3 (1e-9)."""
    mj_state, (AL, AR, C) = _mixed(3)
    dAC, dC, e = ttd.dAC_dC_dt(AL, AR, C, torch.from_numpy(tfim(0.7).to_matrix()))
    dACm, dCm, em = tm.dAC_dC_dt_mpo(AL, AR, C, tm.mpo_tfim(-0.7))
    assert float((dAC - dACm).abs().max()) < 1e-10 and float((dC - dCm).abs().max()) < 1e-10
    assert abs(float(e - em)) < 1e-12
    want = jm.dAC_dC_dt_mpo(*(jnp.asarray(x) for x in mj_state), jm.mpo_nnn_ising(g=0.5, J2=0.2))
    for g, w in zip(tm.dAC_dC_dt_mpo(AL, AR, C, tm.mpo_nnn_ising(g=0.5, J2=0.2)), want):
        np.testing.assert_allclose(to_np(g), np.asarray(w), atol=1e-10)
    AL3, _, _ = ttd.mixed_gauge(torch.from_numpy(_random_A(21, D=3)))
    B = ttd.dA_dt(AL3, tfim(1.2).to_matrix())
    assert float((B - tm.dA_dt_mpo(AL3, tm.mpo_tfim(-1.2))).abs().max()) < 1e-9


@pytest.mark.parametrize("step", ["tdvp_step_mpo", "tdvp_step_rk4_mpo"])
def test_one_mpo_step_matches_jax(step):
    """One MPO-TDVP step under the NNN Ising MPO from the same (AL, C):
    AL, C and e equal JAX's (1e-10)."""
    mj_state, (AL, _, C) = _mixed(4)
    got = getattr(tm, step)(AL, C, tm.mpo_nnn_ising(g=0.5, J2=0.2), 0.01)
    want = getattr(jm, step)(jnp.asarray(mj_state[0]), jnp.asarray(mj_state[2]),
                             jm.mpo_nnn_ising(g=0.5, J2=0.2), 0.01)
    for g, w in zip(got, want):
        np.testing.assert_allclose(to_np(g), np.asarray(w), atol=1e-10)


def test_vumps_mpo_matches_jax():
    """vumps_ground_state_mpo on the exp-decay MPO at D = 4, 40 iterations,
    from the same A0: the energy (1e-10) and every gradient norm (1e-10)
    equal JAX's."""
    A0 = _random_A(6)
    _, _, e, info = tm.vumps_ground_state_mpo(MODELS["exp_decay"](tm), 4, iters=40, A0=A0, device="cpu")
    _, _, ej, infoj = jm.vumps_ground_state_mpo(MODELS["exp_decay"](jm), 4, iters=40, A0=A0)
    assert abs(e - ej) < 1e-10
    np.testing.assert_allclose(to_np(info["grad_norms"]), np.asarray(infoj["grad_norms"]), atol=1e-10)


def test_tfim_mpo_vumps_matches_two_site_vumps():
    """MPO-VUMPS and two-site VUMPS reach the same D = 8 optimum (100
    iterations, k = 24): energies within 1e-10, gradient < 1e-8, within
    1e-5 of exact and variational."""
    _, _, eh, _ = ttd.vumps_ground_state(tfim(1.0).to_matrix(), 8, iters=100, k=24, device="cpu")
    _, _, em, info = tm.vumps_ground_state_mpo(tm.mpo_tfim(-1.0), 8, iters=100, k=24, device="cpu")
    exact = float(tfim_gs_energy_f64(1.0))
    assert abs(eh - em) < 1e-10
    assert float(info["grad_norms"][-1]) < 1e-8
    assert exact - 1e-12 <= em < exact + 1e-5


def test_float32_mpo_vumps_energy_is_read_at_the_unit_trace_fixed_point():
    """In complex64 at D = 8 (60 iterations, k = 24, the same seeded A0):
    the port reads MPO-VUMPS's energy at the unit-trace r of the returned
    state and agrees with two-site VUMPS (2e-6; 7e-7 measured) from above
    the exact energy (-1e-6).  The JAX package reads it through C =
    chol(r + 32 eps I) (qmps_tpu/mps/mpo.py:585-603), whose C C^dag has
    trace 1 + 32 D eps: on the same state that falls 1.2e-5 below exact
    (the pinned difference, ROADMAP.md section 3)."""
    from qmps_torch.mps.imps import random_tensor

    A0 = random_tensor(torch.Generator().manual_seed(2), 2, 8, torch.complex64, "cpu")
    AL, _, em, _ = tm.vumps_ground_state_mpo(tm.mpo_tfim(-1.0), 8, iters=60, k=24, A0=A0)
    _, _, eh, _ = ttd.vumps_ground_state(tfim(1.0).to_matrix(), 8, iters=60, k=24, A0=A0)
    exact = float(tfim_gs_energy_f64(1.0))
    assert AL.dtype == torch.complex64
    assert abs(em - eh) < 2e-6 and em > exact - 1e-6
    r = ttd._true_r(AL)
    C_jittered = torch.linalg.cholesky(r + 32 * torch.finfo(torch.float32).eps * torch.eye(8, dtype=r.dtype))
    assert float(tm.energy_mpo(AL, C_jittered, tm.mpo_tfim(-1.0))) < exact - 5e-6


def test_two_site_matrix_roundtrip_and_long_range_guard():
    """mpo_from_two_site(h).two_site_matrix() == h and mpo_tfim(-g)'s bond
    matrix is tfim(g)'s (1e-12); longer-range MPOs refuse with "range"."""
    h = tfim(0.8).to_matrix()
    np.testing.assert_allclose(tm.mpo_from_two_site(h).two_site_matrix(), h, atol=1e-12)
    np.testing.assert_allclose(tm.mpo_tfim(-0.8).two_site_matrix(), h, atol=1e-12)
    for m in (tm.mpo_nnn_ising(g=0.5, J2=0.2), tm.mpo_exp_decay(-Z, Z, 0.4)):
        with pytest.raises(ValueError, match="range"):
            m.two_site_matrix()


def test_trajectory_mpo_matches_dense_two_site():
    """Trajectory(A0, h=mpo_from_two_site(h)) integrates the dense path's
    flow: Euler tensors agree to 1e-10; RK4's stage points sit off the
    manifold, where the two equivalent subtractions differ by a phase, so
    their tensors agree up to phase to 5e-8 (the JAX test's bounds, from
    its start; the gap is O(dt^3) and depends on the state); the energies
    and echoes to the same tolerances."""
    key = jax.random.PRNGKey(5)  # the JAX test's own start (tests/test_mpo.py:262-265)
    A0 = torch.from_numpy(np.asarray(jax.random.normal(key, (2, 4, 4)) + 1j * jax.random.normal(
        jax.random.fold_in(key, 1), (2, 4, 4))))
    h = tfim(1.1).to_matrix()
    for integ, tol in (("eulerint", 1e-10), ("rk4int", 5e-8)):
        td = getattr(ttd.Trajectory(A0, h), integ)(0.1, 6)
        tmp = getattr(ttd.Trajectory(A0, tm.mpo_from_two_site(h)), integ)(0.1, 6)
        for Ad, Am in zip(to_np(td.ALs), to_np(tmp.ALs)):
            z = np.vdot(Am, Ad)
            assert np.max(np.abs(Ad - z / abs(z) * Am)) < tol, integ
        assert float((td.es - tmp.es).abs().max()) < tol, integ
        np.testing.assert_allclose(to_np(td.loschmidts()), to_np(tmp.loschmidts()), atol=tol)


def test_mps_time_evolve_accepts_a_two_site_mpo():
    """MPSTimeEvolve takes a two-site MPO (its Trotter gate equals the
    dense path's, 1e-12) and refuses a longer-range one with "range";
    as_host_matrix gives the bond matrix."""
    from qmps_torch.ham.hamiltonian import as_host_matrix

    h = tfim(0.2).to_matrix()
    ev_h = MPSTimeEvolve(h, dt=0.02, inner_steps=2)
    ev_m = MPSTimeEvolve(tm.mpo_from_two_site(h), dt=0.02, inner_steps=2)
    np.testing.assert_allclose(ev_m.W, ev_h.W, atol=1e-12)
    np.testing.assert_allclose(as_host_matrix(tm.mpo_tfim(-0.2)), h, atol=1e-12)
    with pytest.raises(ValueError, match="range"):
        MPSTimeEvolve(tm.mpo_nnn_ising(g=0.5, J2=0.2), dt=0.02)


def test_gmres_env_solver_matches_dense():
    """The GMRES environments through the MPO recursion equal the dense
    ones (1e-8) and the energy (1e-12)."""
    _, (AL, AR, C) = _mixed(13)
    m = tm.mpo_tfim(-1.0)
    Ld, Rd, ed = tm.mpo_environments(AL, AR, C, m, env_solver="dense")
    Lg, Rg, eg = tm.mpo_environments(AL, AR, C, m, env_solver="gmres")
    assert float((Ld - Lg).abs().max()) < 1e-8 and float((Rd - Rg).abs().max()) < 1e-8
    assert abs(float(ed - eg)) < 1e-12


@pytest.mark.slow
def test_nnn_ising_vs_ed():
    """MPO-VUMPS on the NNN Ising chain (g 0.5, J2 0.2, D = 16, 200
    iterations) against sparse ED at L = 14: within 1e-5, gradient <
    1e-7, and above ED - 1e-4."""
    _, _, e, info = tm.vumps_ground_state_mpo(tm.mpo_nnn_ising(g=0.5, J2=0.2), 16, iters=200, k=24,
                                              device="cpu")
    assert float(info["grad_norms"][-1]) < 1e-7
    e_ed = nnn_ising_ed_energy(L=14, g=0.5, J2=0.2)
    assert abs(e - e_ed) < 1e-5 and e >= e_ed - 1e-4


@pytest.mark.slow
def test_exp_decay_variational_monotone():
    """The exp-decay model (the interior solve inside VUMPS): D = 8
    converges (gradient < 1e-8) and lies below D = 4."""
    m = tm.mpo_exp_decay(-Z, Z, 0.4, field=-0.8 * X)
    _, _, e4, _ = tm.vumps_ground_state_mpo(m, 4, iters=150, k=24, device="cpu")
    _, _, e8, i8 = tm.vumps_ground_state_mpo(m, 8, iters=150, k=24, device="cpu")
    assert float(i8["grad_norms"][-1]) < 1e-8
    assert e8 <= e4 + 1e-10


@pytest.mark.slow
def test_nnn_quench_matches_finite_ed():
    """The NNN-Ising ground state (MPO-VUMPS, D = 4) quenched g 0.5 -> 0.9
    by MPO-TDVP (RK4, 40 steps to t = 0.4) against dense ED of the same
    quench on an L = 12 ring: <X>(t) within 1e-4 (the start within 2e-5)."""
    g0, g1, J2, L, T, n = 0.5, 0.9, 0.2, 12, 0.4, 40
    AL0, _, _, info = tm.vumps_ground_state_mpo(tm.mpo_nnn_ising(g=g0, J2=J2), 4, iters=150, k=24,
                                                device="cpu")
    assert float(info["grad_norms"][-1]) < 1e-7
    traj = ttd.Trajectory(AL0, tm.mpo_nnn_ising(g=g1, J2=J2)).rk4int(T, n)
    Xt = torch.from_numpy(X + 0j)
    xs_mps = np.array([float(iMPS([A]).Es([Xt])[0]) for A in traj.ALs])

    def site_op(op, i):
        out = np.eye(1)
        for j in range(L):
            out = np.kron(out, op if j == i else I2)
        return out

    def ring_h(g):
        return -sum(site_op(Z, i) @ site_op(Z, (i + 1) % L) + J2 * site_op(Z, i) @ site_op(Z, (i + 2) % L)
                    + g * site_op(X, i) for i in range(L))

    psi = np.linalg.eigh(ring_h(g0))[1][:, 0]
    w1, v1 = np.linalg.eigh(ring_h(g1))
    Xtot = sum(site_op(X, i) for i in range(L)) / L
    c = v1.conj().T @ psi
    xs_ed = []
    for k in range(n + 1):
        psit = v1 @ (np.exp(-1j * w1 * (T * k / n)) * c)
        xs_ed.append(float(np.real(psit.conj() @ (Xtot @ psit))))
    assert abs(xs_mps[0] - xs_ed[0]) < 2e-5
    assert np.max(np.abs(xs_mps - np.array(xs_ed))) < 1e-4
