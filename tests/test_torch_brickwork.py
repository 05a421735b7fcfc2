"""The gen-2 brickwork stack of qmps_torch against qmps_tpu at complex128:
circuits/brickwork (1e-12), the flat overlap and K6's CPU path (1e-12),
the brickwork costs with their real-parameter gradients (1e-8), the
evolver's trajectory (1e-8), the variational environment (1e-6), the
warm-start compile's loss and gradient (1e-8), config 5 on the CPU, and
the JAX package's short brickwork tests on the port (test_brickwork.py).
Inputs come from numpy seeds; random unitaries from numpy QR."""
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import to_np
from qmps_torch.algorithms import brickwork_tdvp as tbt
from qmps_torch.algorithms.ground_state import find_ground_state
from qmps_torch.circuits import brickwork as tbw
from qmps_torch.env.variational import represent_variational_M
from qmps_torch.ham.exact import tfim_gs_energy_f64
from qmps_torch.ham.hamiltonian import tfim
from qmps_torch.kernels.brickwork_fast import manifold_overlap_batched
from qmps_torch.kernels.brickwork_pallas import manifold_overlap_pallas
from qmps_torch.mps.imps import Map
from qmps_torch.workloads import BrickworkConfig
from qmps_tpu.algorithms import brickwork_tdvp as jbt
from qmps_tpu.circuits import brickwork as jbw
from qmps_tpu.env import variational as jvar
from qmps_tpu.kernels import brickwork_fast as jfast

PAIR = ("U1", "U2", "U1d", "U2d")
REPO = Path(__file__).resolve().parent.parent


def _unitaries(rng, *shape):
    """Random unitaries (*shape) from numpy QR of complex normals."""
    Q, _ = np.linalg.qr(rng.standard_normal(shape) + 1j * rng.standard_normal(shape))
    return Q


def _params(seed, scale=0.4):
    return np.random.default_rng(seed).standard_normal(22) * scale


_CIRCUITS = {
    "right_env_map": ("U1", "U2", "U1d", "U2d", "M"),
    "right_env_matrix": PAIR,
    "left_env_matrix": PAIR,
    "exact_right_env": PAIR,
    "exact_left_env": PAIR,
    "env_from_M": ("M", "U2", "U2d"),
    "manifold_overlap": ("U1", "U2", "U1d", "U2d", "M", "Ml", "W"),
    "expectation_2site": ("U1", "U2", "O4"),
    "expectation_4site": ("U1", "U2", "O16"),
    "bricks_to_tensor_left": ("U1", "U2"),
    "bricks_to_tensor_right": ("U1", "U2"),
}


@pytest.mark.parametrize("name", sorted(_CIRCUITS))
def test_circuit_matches_jax(name):
    """Each function of circuits/brickwork on the same random unitaries:
    1e-12 (the dominant eigenvector of the exact environments up to its
    phase)."""
    rng = np.random.default_rng(sorted(_CIRCUITS).index(name))
    pool = {k: _unitaries(rng, 4, 4) for k in PAIR}
    pool.update(M=_unitaries(rng, 2, 2), Ml=_unitaries(rng, 2, 2), W=_unitaries(rng, 16, 16))
    H4, H16 = (rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n)) for n in (4, 16))
    pool.update(O4=H4 + H4.conj().T, O16=H16 + H16.conj().T)
    args = [pool[k] for k in _CIRCUITS[name]]
    out_t = getattr(tbw, name)(*(torch.from_numpy(a) for a in args))
    out_j = getattr(jbw, name)(*(jnp.asarray(a) for a in args))
    if name.startswith("exact_"):
        np.testing.assert_allclose(complex(out_t[0]), complex(out_j[0]), atol=1e-12)
        rt, rj = to_np(out_t[1]).reshape(-1), np.asarray(out_j[1]).reshape(-1)
        ph = np.vdot(rt, rj)
        np.testing.assert_allclose(rt * ph / abs(ph), rj, atol=1e-12)
    else:
        np.testing.assert_allclose(to_np(out_t), np.asarray(out_j), atol=1e-12)


def test_param_bricks_env_M_and_bw_state_match_jax():
    p = _params(1, 1.0)
    for t, j in zip(tbw.param_bricks(torch.from_numpy(p)), jbw.param_bricks(jnp.asarray(p))):
        np.testing.assert_allclose(to_np(t), np.asarray(j), atol=1e-12)
    np.testing.assert_allclose(to_np(tbw.env_M(torch.from_numpy(p[:6]))),
                               np.asarray(jbw.env_M(jnp.asarray(p[:6]))), atol=1e-12)
    U1, U2 = jbw.param_bricks(jnp.asarray(p))
    for l in (2, 3):
        psi = tbw.bw_state(*(torch.from_numpy(np.array(u)) for u in (U1, U2)), l)
        np.testing.assert_allclose(to_np(psi), np.asarray(jbw.bw_state(U1, U2, l)), atol=1e-12)


def test_circuits_batch():
    """A (3,) batch of brick pairs through the port at once against each
    pair alone."""
    rng = np.random.default_rng(5)
    U = [_unitaries(rng, 3, 4, 4) for _ in range(4)]
    M, W = _unitaries(rng, 3, 2, 2), _unitaries(rng, 16, 16)
    t = [torch.from_numpy(x) for x in (*U, M)]
    ov = tbw.manifold_overlap(*t, t[4].mH, torch.from_numpy(W))
    env = tbw.right_env_matrix(*t[:4])
    for i in range(3):
        one = [x[i] for x in t]
        np.testing.assert_allclose(complex(ov[i]), complex(tbw.manifold_overlap(*one, one[4].mH, torch.from_numpy(W))),
                                   atol=1e-14)
        np.testing.assert_allclose(to_np(env[i]), to_np(tbw.right_env_matrix(*one[:4])), atol=1e-14)


def test_exact_right_env_matches_blocked_map():
    """The brickwork right-transfer eigenvalue equals the dominant
    eigenvalue of the mixed transfer map of the blocked (d = 4) tensors
    (test_brickwork.py:67-82): 1e-8."""
    U1, U2 = tbw.param_bricks(torch.from_numpy(_params(2)))
    U1p, U2p = tbw.param_bricks(torch.from_numpy(_params(3)))
    eta, _ = tbw.exact_right_env(U1, U2, U1p.mH, U2p.mH)
    A = tbw.bricks_to_tensor_left(U1, U2).transpose(0, 1)
    B = tbw.bricks_to_tensor_left(U1p, U2p).transpose(0, 1)
    x, _ = Map(A, B).right_fixed_point()
    np.testing.assert_allclose(complex(eta), complex(x), atol=1e-8)


def _overlap_inputs(B, seed):
    rng = np.random.default_rng(seed)
    U1, U2, U1p, U2p = (_unitaries(rng, B, 4, 4) for _ in range(4))
    M = _unitaries(rng, B, 2, 2)
    return U1, U2, U1p, U2p, M, np.conj(np.swapaxes(M, -1, -2)), _unitaries(rng, 16, 16)


def test_flat_overlap_matches_einsum_and_jax():
    """manifold_overlap_batched against the 13-operand network, pair by
    pair (test_brickwork.py:85-105), and against JAX's flat form: 1e-12."""
    args = _overlap_inputs(5, 6)
    U1, U2, U1p, U2p, M, Ml, W = (torch.from_numpy(a) for a in args)
    fast = manifold_overlap_batched(U1, U2, U1p, U2p, M, Ml, W)
    ref = torch.stack([tbw.manifold_overlap(U1[i], U2[i], U1p[i].mH, U2p[i].mH, M[i], Ml[i], W)
                       for i in range(5)])
    np.testing.assert_allclose(to_np(fast), to_np(ref), atol=1e-12)
    np.testing.assert_allclose(to_np(fast), np.asarray(jfast.manifold_overlap_batched(*map(jnp.asarray, args))),
                               atol=1e-12)


def test_overlap_pallas_cpu_matches_jax_flat_form():
    """K6's wrapper on CPU tensors (its plain version) against JAX's
    manifold_overlap_batched, the reference the JAX tests pin the Pallas
    kernel to: 1e-12 at B = 37."""
    args = _overlap_inputs(37, 7)
    out = manifold_overlap_pallas(*(torch.from_numpy(a) for a in args))
    assert out.shape == (37,) and out.dtype == torch.complex128
    np.testing.assert_allclose(to_np(out), np.asarray(jfast.manifold_overlap_batched(*map(jnp.asarray, args))),
                               atol=1e-12)


@pytest.mark.slow
def test_overlap_pallas_cpu_matches_jax_interpret_kernel():
    """Against JAX's interpret-mode manifold_overlap_pallas on a batch that
    is not a multiple of the 128-lane tile (B = 7), inputs rounded to
    complex64 for both: 2e-6 (tests/test_pallas.py:212; ~1 min on a CPU)."""
    from qmps_tpu.kernels.brickwork_pallas import manifold_overlap_pallas as jpallas

    args = [a.astype(np.complex64) for a in _overlap_inputs(7, 8)]
    ref = np.asarray(jpallas(*map(jnp.asarray, args), interpret=True))
    out = manifold_overlap_pallas(*(torch.from_numpy(a.astype(np.complex128)) for a in args))
    np.testing.assert_allclose(to_np(out), ref, atol=2e-6)


def _grad_parity(fn_t, fn_j, p, *rest_t, rest_j=()):
    """Value and gradient in the first (real) argument: torch's .grad
    against jax.grad, 1e-8."""
    x = torch.tensor(p, requires_grad=True)
    v_t = fn_t(x, *rest_t)
    v_t.backward()
    v_j, g_j = jax.value_and_grad(lambda q: fn_j(q, *rest_j))(jnp.asarray(p))
    np.testing.assert_allclose(float(v_t.detach()), float(v_j), atol=1e-8)
    np.testing.assert_allclose(to_np(x.grad), np.asarray(g_j), atol=1e-8)


@pytest.mark.parametrize("O", ["2site", "4site"])
def test_brickwork_energy_and_gradient_match_jax(O):
    rng = np.random.default_rng(9)
    n = 4 if O == "2site" else 16
    H = rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))
    H = H + H.conj().T
    _grad_parity(tbt.brickwork_energy, jbt.brickwork_energy, _params(10), torch.from_numpy(H),
                 rest_j=(jnp.asarray(H),))


def test_bw_layer_energy_and_gradient_match_jax():
    h = tfim(1.3).to_matrix()
    _grad_parity(tbt.bw_layer_energy, jbt.bw_layer_energy, _params(11), torch.from_numpy(h),
                 rest_j=(jnp.asarray(h),))


@pytest.mark.parametrize("cost", ["evolve_cost_eig", "evolve_cost_exact_env"])
def test_evolve_costs_and_gradients_match_jax(cost):
    """Both TDVP costs at params_new near params_cur, W the quench window
    gate: value and gradient in params_new to 1e-8.  The exact-env cost's
    gradient is held to central differences (h 1e-5) of the JAX value:
    JAX's own gradient runs AD through 40 squarings, whose rounding is
    amplified by up to 2^40 (ROADMAP.md, section 3), and agrees with the
    port's implicit adjoint to 1e-5 only, pinned here."""
    p_cur = _params(12)
    p_new = p_cur + 0.05 * np.random.default_rng(13).standard_normal(22)
    W = tbt.quench_window_gate(tfim(0.2).to_matrix(), 0.05)
    rest_t, rest_j = (torch.from_numpy(p_cur), torch.from_numpy(W)), (jnp.asarray(p_cur), jnp.asarray(W))
    if cost == "evolve_cost_eig":
        _grad_parity(tbt.evolve_cost_eig, jbt.evolve_cost_eig, p_new, *rest_t, rest_j=rest_j)
        return
    x = torch.tensor(p_new, requires_grad=True)
    v_t = tbt.evolve_cost_exact_env(x, *rest_t)
    v_t.backward()

    def f(q):
        return float(jbt.evolve_cost_exact_env(jnp.asarray(q), *rest_j))

    fd = np.array([(f(p_new + 1e-5 * e) - f(p_new - 1e-5 * e)) / 2e-5 for e in np.eye(22)])
    np.testing.assert_allclose(float(v_t.detach()), f(p_new), atol=1e-8)
    np.testing.assert_allclose(to_np(x.grad), fd, atol=1e-8)
    g_j = jax.grad(lambda q: jbt.evolve_cost_exact_env(q, *rest_j))(jnp.asarray(p_new))
    np.testing.assert_allclose(to_np(x.grad), np.asarray(g_j), atol=1e-5)


def test_quench_window_gate_matches_jax():
    h = tfim(0.2).to_matrix()
    np.testing.assert_array_equal(tbt.quench_window_gate(h, 0.05), jbt.quench_window_gate(h, 0.05))


def test_evolver_trajectory_matches_jax():
    """From the same p0, 2 outer steps of 15 adam steps (the same formula)
    with the quench window gate: trajectory and costs to 1e-8."""
    p0 = _params(14)
    W = tbt.quench_window_gate(tfim(0.2).to_matrix(), 0.05)
    traj_t, costs_t = tbt.BrickworkEvolver(W, inner_steps=15, lr=2e-2, device="cpu").time_evolve(p0, 2)
    traj_j, costs_j = jbt.BrickworkEvolver(jnp.asarray(W), inner_steps=15, lr=2e-2).time_evolve(jnp.asarray(p0), 2)
    assert traj_t.shape == (3, 22) and costs_t.shape == (2,)
    np.testing.assert_allclose(to_np(traj_t), np.asarray(traj_j), atol=1e-8)
    np.testing.assert_allclose(to_np(costs_t), np.asarray(costs_j), atol=1e-8)


def test_represent_variational_M_matches_jax():
    """From the default p0, 120 adam steps with the exponential decay, the
    bricks of a nearby pair: eta and M to 1e-6."""
    p = _params(15)
    U1, U2 = jbw.param_bricks(jnp.asarray(p))
    U1p, U2p = jbw.param_bricks(jnp.asarray(p + 0.05))
    bricks = (U1, U2, U1p.conj().T, U2p.conj().T)
    eta_j, M_j, res_j = jvar.represent_variational_M(*bricks, steps=120)
    eta_t, M_t, res_t = represent_variational_M(*(torch.from_numpy(np.array(b)) for b in bricks), steps=120)
    np.testing.assert_allclose(float(eta_t), float(eta_j), atol=1e-6)
    np.testing.assert_allclose(to_np(M_t), np.asarray(M_j), atol=1e-6)
    np.testing.assert_allclose(float(res_t), float(res_j), atol=1e-6)


def _gs_tensor():
    """A left-canonical D = 2 tensor (2, 2, 2) near a TFIM ground state."""
    x = np.random.default_rng(16).standard_normal((4, 2)) + 1j * np.random.default_rng(17).standard_normal((4, 2))
    V, _ = np.linalg.qr(x)
    return V.reshape(2, 2, 2)


def test_compile_loss_and_gradient_match_jax():
    """The warm-start compile's loss (n_starts rows at once in the port)
    at given parameters, value and gradient: 1e-8, row by row against the
    JAX loss (brickwork_tdvp.py:181-186)."""
    from qmps_tpu.mps import transfer as jtr
    from qmps_tpu.mps.imps import iMPS as jiMPS
    from qmps_tpu.mps.imps import merge as jmerge
    from qmps_torch.mps.imps import iMPS, merge

    A = _gs_tensor()
    Ablk_t = iMPS([merge(torch.from_numpy(A), torch.from_numpy(A))]).left_canonicalise()[0]
    Ablk_j = jiMPS([jmerge(jnp.asarray(A), jnp.asarray(A))]).left_canonicalise()[0]
    np.testing.assert_allclose(to_np(Ablk_t), np.asarray(Ablk_j), atol=1e-10)

    def loss_j(params):
        U1, U2 = jbw.param_bricks(params)
        Bb = jnp.transpose(jbw.bricks_to_tensor_left(U1, U2), (1, 0, 2))
        lam_ab = jtr.dominant_eigval_dense(jtr.transfer_dense(Ablk_j, Bb))
        lam_bb = jtr.dominant_eigval_dense(jtr.transfer_dense(Bb, Bb))
        return -(jnp.abs(lam_ab) ** 2 / jnp.abs(lam_bb)).real

    ps = np.random.default_rng(18).uniform(size=(3, 22))
    x = torch.tensor(ps, requires_grad=True)
    vals = tbt._compile_losses(Ablk_t, x)
    vals.sum().backward()
    vals = vals.detach()
    for i in range(3):
        v_j, g_j = jax.value_and_grad(loss_j)(jnp.asarray(ps[i]))
        np.testing.assert_allclose(float(vals[i]), float(v_j), atol=1e-8)
        np.testing.assert_allclose(to_np(x.grad[i]), np.asarray(g_j), atol=1e-8)


def test_compile_tensor_to_bricks_raises_the_overlap():
    """A short run (2 starts, 150 steps): the returned overlap is above
    every start's and at most 1."""
    from qmps_torch.mps.imps import iMPS, merge

    A = torch.from_numpy(_gs_tensor())
    p, ov = tbt.compile_tensor_to_bricks(A, steps=150, n_starts=2)
    Ablk = iMPS([merge(A, A)]).left_canonicalise()[0]
    p0s = torch.rand((2, 22), generator=torch.Generator().manual_seed(0), dtype=torch.float64)
    start = (-tbt._compile_losses(Ablk, p0s)).max()
    assert p.shape == (22,) and float(start) < float(ov) <= 1 + 1e-10, (float(start), float(ov))


def test_brickwork_ground_state():
    """test_brickwork.py:132-135 on the port (torch's L-BFGS): the windowed
    objective within 5e-2 of exact."""
    res = tbt.optimize_brickwork(tfim(1.0).to_matrix(), steps=250, device="cpu")
    assert res.fun - float(tfim_gs_energy_f64(1.0)) < 5e-2


def test_brickwork_evolve_stationary():
    """test_brickwork.py:138-150 on the port: with W = I, a few warm-started
    inner steps barely move the parameters, and the exact-env cost is
    negative."""
    p = _params(19, 0.3)
    eye = np.eye(16, dtype=np.complex128)
    traj, costs = tbt.BrickworkEvolver(eye, inner_steps=40, lr=5e-3, device="cpu").time_evolve(p, 2)
    drift = float(torch.linalg.norm(traj[-1] - traj[0]))
    assert drift < 0.2, drift
    pt = torch.from_numpy(p)
    assert float(tbt.evolve_cost_exact_env(pt, pt, torch.from_numpy(eye))) < 0


def test_windowed_energy_identity_bricks():
    """Zero params -> identity bricks -> |00..>: <-ZZ> = -1."""
    Z = np.diag([1.0, -1.0])
    e = float(tbt.brickwork_energy(torch.zeros(22, dtype=torch.float64), torch.from_numpy(-np.kron(Z, Z))))
    np.testing.assert_allclose(e, -1.0, atol=1e-9)


def test_bricks_to_tensor_canonical_forms():
    """test_brickwork.py:51-64: the left-leaning form is left-canonical and
    the right-leaning form right-canonical after reordering to (d, D, D);
    the bricks are unitary and the brickwork states normalized."""
    U1, U2 = tbw.param_bricks(torch.from_numpy(_params(20)))
    for U in (U1, U2):
        np.testing.assert_allclose(to_np(U.mH @ U), np.eye(4), atol=1e-10)
    AL = to_np(tbw.bricks_to_tensor_left(U1, U2).transpose(0, 1))
    np.testing.assert_allclose(np.einsum("sik,sil->kl", AL.conj(), AL), np.eye(2), atol=1e-10)
    AR = to_np(tbw.bricks_to_tensor_right(U1, U2).transpose(0, 1))
    np.testing.assert_allclose(np.einsum("sik,slk->il", AR, AR.conj()), np.eye(2), atol=1e-10)
    for l in (2, 3):
        assert abs(float(torch.linalg.norm(tbw.bw_state(U1, U2, l))) - 1) < 1e-10


def test_loschmidt_echo_brickwork_short():
    """Two steps of the Loschmidt pipeline from a random state (CPU,
    float64): overlaps in (0, 1], equal to the JAX pipeline's to 1e-8."""
    p0 = _params(21, 0.3)
    W = tbt.quench_window_gate(tfim(0.2).to_matrix(), 0.05)
    les_t, traj_t, _ = tbt.loschmidt_echo_brickwork(p0, W, n_steps=2, inner_steps=10, device="cpu")
    les_j, traj_j, _ = jbt.loschmidt_echo_brickwork(jnp.asarray(p0), jnp.asarray(W), n_steps=2, inner_steps=10)
    assert les_t.shape == (2,) and bool(((les_t > 0) & (les_t <= 1 + 1e-12)).all())
    np.testing.assert_allclose(to_np(les_t), np.asarray(les_j), atol=1e-8)


def test_brickwork_config_on_cpu():
    """Config 5 at a small batch with device="cpu": the flat row only (the
    fused row needs the card), a positive finite rate."""
    m = BrickworkConfig(batch=64, iters=2, device="cpu").run()
    assert m["device"] == "cpu" and "overlap_evals_per_sec_fused" not in m
    assert np.isfinite(m["overlap_evals_per_sec"]) and m["overlap_evals_per_sec"] > 0


@pytest.mark.parametrize("case", ["loschmidt_float64", "loschmidt_float32", "find_ground_state_float32",
                                  "optimize_brickwork_complex64"])
def test_tensor_inputs_set_device_and_precision(case, monkeypatch):
    """On a machine without a card, an entry point given a CPU tensor (p0
    with W as numpy, the start, or h) runs on the CPU in that tensor's
    precision rather than raising."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    if case.startswith("loschmidt"):
        want = torch.float32 if case.endswith("32") else torch.float64
        W = tbt.quench_window_gate(tfim(0.2).to_matrix(), 0.05)
        les, out, _ = tbt.loschmidt_echo_brickwork(torch.from_numpy(_params(22, 0.3)).to(want), W,
                                                   n_steps=1, inner_steps=2)
        assert les.dtype == want
    elif case == "find_ground_state_float32":
        want = torch.float32
        out = find_ground_state(tfim(1.0), steps=1, initial_guess=torch.from_numpy(_params(23)[:15]).float()).params
    else:
        want = torch.float32
        h = torch.from_numpy(tfim(1.0).to_matrix()).to(torch.complex64)
        out = tbt.optimize_brickwork(h, steps=1).x
    assert out.device.type == "cpu" and out.dtype == want


@pytest.mark.slow
def test_brickwork_family_float32_on_cpu():
    """chip_smoke.py's phase 10 (``brickwork_family``, which gates both
    paths against the exact Loschmidt rate) in the card's float32 on the
    CPU, from the float32 brickwork ground state of tfim(1.5) (400 L-BFGS
    steps); the float32 "suN" ground state within 5e-4 of exact.  Prints
    its figures (run with -s)."""
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    res = tbt.optimize_brickwork(torch.from_numpy(tfim(1.5).to_matrix()).to(torch.complex64), 400)
    assert res.x.dtype == torch.float32 and res.x.device.type == "cpu"
    fam = chip_smoke.brickwork_family(res.x)
    print(fam)
    assert -1e-9 < fam["suN_ground_state_error"] < 5e-4
