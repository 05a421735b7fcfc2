"""The classical uMPS TDVP of qmps_torch (mps/tdvp: the energy density, the
Hamiltonian environments, the effective Hamiltonians and tangents, the
Euler and RK4 steppers, ``Trajectory``) against qmps_tpu's at complex128
on the CPU, on the same numpy inputs, and the invariants of
tests/test_tdvp_classical.py:22-170.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import to_np
from qmps_torch.algorithms.ground_state import find_ground_state
from qmps_torch.ham.exact import loschmidt_rate
from qmps_torch.ham.hamiltonian import tfim
from qmps_torch.mps import tdvp as ttd
from qmps_torch.mps import transfer as ttr
from qmps_torch.mps.imps import iMPS
from qmps_torch.utils.convert import from_mixed_gauge
from qmps_tpu.mps import tdvp as jtd
from qmps_tpu.mps.imps import iMPS as JiMPS


def _random_A(seed, D, d=2):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((d, D, D)) + 1j * rng.standard_normal((d, D, D))


@pytest.fixture(scope="module")
def state():
    """(A, (AL, AR, C) numpy from JAX's mixed gauge, the port's triple from
    them, h) at D = 4, TFIM g = 1.2."""
    A = _random_A(0, 4)
    mj = tuple(np.asarray(x) for x in jtd.mixed_gauge(jnp.asarray(A)))
    return A, mj, from_mixed_gauge(mj), tfim(1.2).to_matrix()


def test_mixed_gauge_is_the_jax_packages(state):
    """mixed_gauge (the port's iMPS.mixed) gives JAX's (AL, AR, C) (1e-10)."""
    A, mj, _, _ = state
    for got, want in zip(ttd.mixed_gauge(torch.from_numpy(A)), mj):
        np.testing.assert_allclose(to_np(got), want, atol=1e-10)


def test_energy_density_matches_jax_and_imps(state):
    """energy_density equals JAX's and the port's iMPS.energy (1e-10)."""
    A, mj, (AL, _, C), h = state
    e = float(ttd.energy_density(AL, C, torch.from_numpy(h)))
    assert abs(e - float(jtd.energy_density(*(jnp.asarray(x) for x in (mj[0], mj[2], h))))) < 1e-10
    assert abs(e - float(iMPS([torch.from_numpy(A)]).energy(torch.from_numpy(h)))) < 1e-10


@pytest.mark.parametrize("solver", ["dense", "gmres"])
def test_environments_match_jax(state, solver):
    """hamiltonian_environments: HL, HR and e equal JAX's with the same
    solver (1e-10)."""
    _, mj, (AL, AR, C), h = state
    got = ttd.hamiltonian_environments(AL, AR, C, torch.from_numpy(h), env_solver=solver)
    want = jtd.hamiltonian_environments(*(jnp.asarray(x) for x in (*mj, h)), env_solver=solver)
    for g, w in zip(got, want):
        np.testing.assert_allclose(to_np(g), np.asarray(w), atol=1e-10)


def test_environment_solves_satisfy_their_equations():
    """HL and HR satisfy the regularized equations they document (the
    right solve's rank-1 row once encoded tr(l^T x): residual 0.23 on
    complex states), at D = 3 (1e-10)."""
    AL, AR, C = ttd.mixed_gauge(torch.from_numpy(_random_A(1, 3)))
    h = torch.from_numpy(tfim(1.2).to_matrix())
    HL, HR, _ = ttd.hamiltonian_environments(AL, AR, C, h)
    r, l, eye = C @ C.mH, C.mH @ C, torch.eye(3, dtype=C.dtype)
    h4 = h.reshape(2, 2, 2, 2)
    AL2, AR2 = ttd._two_site(AL), ttd._two_site(AR)
    hL = torch.einsum("uvia,stib,uvst->ab", AL2.conj(), AL2, h4)
    hL = hL - torch.trace(hL @ r).real * eye
    hR = torch.einsum("stak,uvbk,uvst->ab", AR2, AR2.conj(), h4)
    hR = hR - torch.trace(l @ hR) * eye
    resL = HL - torch.einsum("sia,sjb,ij->ab", AL.conj(), AL, HL) + torch.trace(HL @ r) * eye - hL
    resR = HR - torch.einsum("sai,sbj,ij->ab", AR, AR.conj(), HR) + torch.trace(l @ HR) * eye - hR
    assert float(torch.linalg.matrix_norm(resL)) < 1e-10
    assert float(torch.linalg.matrix_norm(resR)) < 1e-10


def test_effective_hamiltonians_match_jax(state):
    """effective_H_AC and effective_H_C on random AC and C at JAX's
    environments equal JAX's (1e-10)."""
    _, mj, (AL, AR, C), h = state
    HL, HR, _ = jtd.hamiltonian_environments(*(jnp.asarray(x) for x in (*mj, h)))
    rng = np.random.default_rng(2)
    X = rng.standard_normal((2, 4, 4)) + 1j * rng.standard_normal((2, 4, 4))
    Y = rng.standard_normal((4, 4)) + 1j * rng.standard_normal((4, 4))
    HLt, HRt, ht = (torch.from_numpy(np.asarray(x)) for x in (HL, HR, h))
    jargs = (jnp.asarray(mj[0]), jnp.asarray(mj[1]), HL, HR, jnp.asarray(h))
    np.testing.assert_allclose(to_np(ttd.effective_H_AC(torch.from_numpy(X), AL, AR, HLt, HRt, ht)),
                               np.asarray(jtd.effective_H_AC(jnp.asarray(X), *jargs)), atol=1e-10)
    np.testing.assert_allclose(to_np(ttd.effective_H_C(torch.from_numpy(Y), AL, AR, HLt, HRt, ht)),
                               np.asarray(jtd.effective_H_C(jnp.asarray(Y), *jargs)), atol=1e-10)


def test_effective_hamiltonians_are_batched(state):
    """A batch of two states gives each one's H_AC(AC), H_C(C) and tangent
    (1e-12)."""
    _, _, (AL, AR, C), h = state
    AL2, AR2, C2 = ttd.mixed_gauge(torch.from_numpy(_random_A(5, 4)))
    ht = torch.from_numpy(h)
    b = [torch.stack(p) for p in ((AL, AL2), (AR, AR2), (C, C2))]
    dAC, dC, e = ttd.dAC_dC_dt(*b, ht)
    for i, one in enumerate([(AL, AR, C), (AL2, AR2, C2)]):
        ref = ttd.dAC_dC_dt(*one, ht)
        for got, want in zip((dAC[i], dC[i], e[i]), ref):
            torch.testing.assert_close(got, want, atol=1e-12, rtol=0)


def test_tangents_match_jax(state):
    """dAC_dC_dt, dA_dt and iMPS.dA_dt equal JAX's (1e-10)."""
    A, mj, (AL, AR, C), h = state
    ht = torch.from_numpy(h)
    got = ttd.dAC_dC_dt(AL, AR, C, ht)
    want = jtd.dAC_dC_dt(*(jnp.asarray(x) for x in (*mj, h)))
    for g, w in zip(got, want):
        np.testing.assert_allclose(to_np(g), np.asarray(w), atol=1e-10)
    B_j = np.asarray(jtd.dA_dt(jnp.asarray(mj[0]), jnp.asarray(h)))
    np.testing.assert_allclose(to_np(ttd.dA_dt(AL, ht)), B_j, atol=1e-10)
    np.testing.assert_allclose(to_np(iMPS([AL]).dA_dt(ht)), np.asarray(JiMPS([jnp.asarray(mj[0])]).dA_dt(
        jnp.asarray(h))), atol=1e-10)


@pytest.mark.parametrize("step", ["tdvp_step", "tdvp_step_rk4"])
def test_one_step_matches_jax(state, step):
    """One Euler or RK4 step from the same (AL, C): AL (up to one global
    phase, though the polar retraction fixes it), C and e equal JAX's
    (1e-10)."""
    _, mj, (AL, _, C), h = state
    got = getattr(ttd, step)(AL, C, torch.from_numpy(h), 0.01)
    want = getattr(jtd, step)(jnp.asarray(mj[0]), jnp.asarray(mj[2]), jnp.asarray(h), 0.01)
    a, b = to_np(got[0]), np.asarray(want[0])
    z = np.vdot(a, b)
    np.testing.assert_allclose(a * z / abs(z), b, atol=1e-10)
    np.testing.assert_allclose(to_np(got[1]), np.asarray(want[1]), atol=1e-10)
    assert abs(float(got[2]) - float(want[2])) < 1e-10


@pytest.mark.parametrize("integ", ["eulerint", "rk4int"])
def test_trajectory_matches_jax(integ):
    """Trajectory at D = 4 over 6 steps to t = 0.06, TFIM 1.1: every AL (up
    to its phase), every energy and every Loschmidt echo equal JAX's
    (1e-10)."""
    A0 = _random_A(3, 4)
    h = tfim(1.1).to_matrix()
    tt = getattr(ttd.Trajectory(torch.from_numpy(A0), h), integ)(0.06, 6)
    tj = getattr(jtd.Trajectory(jnp.asarray(A0), jnp.asarray(h)), integ)(0.06, 6)
    assert tt.ALs.shape == (7, 2, 4, 4) and tt.es.shape == (6,)
    for a, b in zip(to_np(tt.ALs), np.asarray(tj.ALs)):
        z = np.vdot(a, b)
        np.testing.assert_allclose(a * z / abs(z), b, atol=1e-10)
    np.testing.assert_allclose(to_np(tt.es), np.asarray(tj.es), atol=1e-10)
    np.testing.assert_allclose(to_np(tt.loschmidts()), np.asarray(tj.loschmidts()), atol=1e-10)


def test_ground_state_is_stationary():
    """On the variational ground state the physical tangent dAC - AL dC
    vanishes up to the optimizer's own convergence (< 5e-3).  The port's
    L-BFGS is torch's (ROADMAP.md section 3): at 150 steps, where the JAX
    test stops, it stands at 2.8e-2; at 300 it has converged (4.8e-5)."""
    gs = find_ground_state(tfim(1.0), D=2, ansatz="suN", method="lbfgs", steps=300, device="cpu")
    AL, AR, C = ttd.mixed_gauge(gs.A)
    dAC, dC, _ = ttd.dAC_dC_dt(AL, AR, C, torch.from_numpy(tfim(1.0).to_matrix()))
    assert float(torch.linalg.vector_norm(dAC - AL @ dC)) < 5e-3


def test_gauge_preserved_along_flow():
    """Ten Euler steps keep AL left-canonical (1e-9)."""
    h = torch.from_numpy(tfim(0.7).to_matrix())
    AL, _, C = ttd.mixed_gauge(torch.from_numpy(_random_A(4, 4)))
    for _ in range(10):
        AL, C, _ = ttd.tdvp_step(AL, C, h, 0.01)
    np.testing.assert_allclose(to_np(torch.einsum("sia,sib->ab", AL.conj(), AL)), np.eye(4), atol=1e-9)


def test_dA_dt_preserves_the_norm():
    """An Euler step along dA_dt keeps the state normalized to O(dt^2)
    (1e-6 at dt = 1e-3)."""
    A = iMPS([torch.from_numpy(_random_A(6, 2))]).left_canonicalise()[0]
    A2 = A + 1e-3 * ttd.dA_dt(A, tfim(1.0).to_matrix())
    np.testing.assert_allclose(float(iMPS([A2]).overlap(iMPS([A2]))), 1.0, atol=1e-6)


def test_trajectory_device_and_precision():
    """A CPU tensor A0 runs on the CPU in its precision: complex64 stays
    complex64 (the card's type), and a numpy A0 asks for device='cpu'."""
    A0 = torch.from_numpy(_random_A(7, 3)).to(torch.complex64)
    tr64 = ttd.Trajectory(A0, tfim(0.5).to_matrix()).eulerint(0.02, 2)
    assert tr64.ALs.dtype == torch.complex64 and tr64.ALs.device.type == "cpu"
    tr = ttd.Trajectory(_random_A(7, 3), tfim(0.5), device="cpu").eulerint(0.02, 2)
    assert tr.ALs.dtype == torch.complex128
    np.testing.assert_allclose(to_np(tr64.loschmidts()), to_np(tr.loschmidts()), atol=1e-5)


@pytest.mark.slow
def test_energy_conserved_along_flow():
    """40 Euler steps at dt = 5e-3 conserve the energy density (5e-3)."""
    h = torch.from_numpy(tfim(1.0).to_matrix())
    AL, _, C = ttd.mixed_gauge(torch.from_numpy(_random_A(8, 4)))
    es = []
    for _ in range(40):
        AL, C, e = ttd.tdvp_step(AL, C, h, 0.005)
        es.append(float(e))
    assert abs(es[-1] - es[0]) < 5e-3


@pytest.mark.slow
def test_quench_loschmidt_vs_exact_rate():
    """TFIM quench 1.5 -> 0.2 at D = 8 from the "suN" L-BFGS ground state:
    the Euler rate (dt 1e-3) within 1e-2 of the exact rate function
    through the dynamical phase transition (tests/test_tdvp_classical.py:
    62-77)."""
    gs0 = find_ground_state(tfim(1.5), D=8, ansatz="suN", method="lbfgs", steps=400, device="cpu")
    traj = ttd.Trajectory(gs0.A, tfim(0.2).to_matrix()).eulerint(1.2, 1200)
    rates = -np.log(to_np(traj.loschmidts()))
    ts = np.linspace(1.2 / 1200, 1.2, 1200)
    sel = slice(149, None, 150)
    assert np.max(np.abs(rates[sel] - loschmidt_rate(ts[sel], 1.5, 0.2))) < 1e-2


@pytest.mark.slow
def test_rk4_matches_euler_and_conserves():
    """RK4 (10 steps of 0.01) against small-dt Euler (40 of 0.0025): the
    same state (|mixed-transfer eigenvalue| within 1e-4 of 1), energy
    conserved (1e-3), AL left-canonical (1e-9)."""
    h = torch.from_numpy(tfim(0.9).to_matrix())
    AL, _, C = ttd.mixed_gauge(torch.from_numpy(_random_A(9, 4)))
    ALe, Ce = AL, C
    for _ in range(40):
        ALe, Ce, _ = ttd.tdvp_step(ALe, Ce, h, 0.0025)
    AL4, C4, es = AL, C, []
    for _ in range(10):
        AL4, C4, e = ttd.tdvp_step_rk4(AL4, C4, h, 0.01)
        es.append(float(e))
    lam, _ = ttr.right_fixed_point(AL4, ALe)
    assert abs(float(lam.abs()) - 1.0) < 1e-4
    assert abs(es[-1] - es[0]) < 1e-3
    np.testing.assert_allclose(to_np(torch.einsum("sia,sib->ab", AL4.conj(), AL4)), np.eye(4), atol=1e-9)


@pytest.mark.slow
def test_neel_quench_tracks_exact_evolution():
    """The Neel state evolved under Heisenberg by blocked-cell RK4 TDVP (d
    = 4, D = 16, 320 steps to t = 0.8) tracks the L = 14 exact staggered
    magnetization of tests/test_tdvp_classical.py:536-570 within 0.02, and
    its entanglement grows."""
    from qmps_torch.ham.hamiltonian import block_two_site, heisenberg

    ms_ed = np.array([1.0, 0.84829, 0.48173, 0.09771, -0.13814, -0.18342, -0.10542, -0.00378, 0.05627])
    # examples/neel_quench.py's start: |up down> a cell, padded to D = 16
    # with 1e-2 noise
    A = np.zeros((4, 16, 16), np.complex128)
    A[1, 0, 0] = 1.0
    rng = np.random.default_rng(0)
    A += 1e-2 * (rng.standard_normal(A.shape) + 1j * rng.standard_normal(A.shape))
    h2 = np.asarray(heisenberg().to_matrix()).real
    traj = ttd.Trajectory(torch.from_numpy(A), block_two_site(h2)).rk4int(0.8, 320)
    Z, I2 = np.diag([1.0, -1.0]), np.eye(2)
    op = torch.from_numpy((np.kron(Z, I2) - np.kron(I2, Z)) / 2 + 0j)
    sel = np.linspace(0, 320, 9).astype(int)
    ms = np.array([float(iMPS([traj.ALs[i]]).E(op).real) for i in sel])
    assert np.max(np.abs(ms - ms_ed)) < 0.02
    S = [float(iMPS([traj.ALs[i]]).entanglement_entropy()) for i in (40, 160, 320)]
    assert S[0] < S[1] < S[2]
