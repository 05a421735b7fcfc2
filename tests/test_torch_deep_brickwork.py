"""qmps_torch's deep brick-wall ansatz (circuits/brickwork_deep.py, the
batched core.lie.U4_kak) and ground_state_deep_brickwork against
qmps_tpu's, at complex128 on the CPU, and tests/test_deep_brickwork.py's
eleven tests ported with their sizes and bounds (the two slow ones slow).
Starts come from the JAX package's keys, drawn with JAX and carried across
by utils/convert.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import assert_brick_params_match, dispatched, to_np
from qmps_torch.algorithms import ground_state_deep_brickwork
from qmps_torch.circuits.brickwork_deep import (
    _n_qubits,
    brick_layout,
    brick_wall_ops,
    brick_wall_tensor,
    brick_wall_unitary,
    n_brick_params,
)
from qmps_torch.circuits.ir import circuit_unitary
from qmps_torch.core import lie as tlie
from qmps_torch.ham.exact import tfim_gs_energy_f64
from qmps_torch.ham.hamiltonian import tfim
from qmps_torch.parallel import sweep as tsw
from qmps_torch.utils.convert import from_numpy
from qmps_tpu.algorithms import ground_state_deep_brickwork as jax_ground_state_deep_brickwork
from qmps_tpu.circuits import brickwork_deep as jbd
from qmps_tpu.core import lie as jlie
from qmps_tpu.ham import tfim as jax_tfim


def _normal(seed, shape, scale):
    """The JAX package's start: normal(PRNGKey(seed), shape) * scale."""
    return from_numpy(jax.random.normal(jax.random.PRNGKey(seed), shape)) * scale


def _sweep_from_jax_starts(gs, D, steps, refine_passes=0, recycle=None, seed=0):
    """The port's sweep from the starts JAX's sweep_ground_states draws
    from PRNGKey(seed) (restarts 1: no jitter)."""
    _, k = tsw._sweep_ansatz("deep_bw", D)
    p0s = _normal(seed, (len(gs), 1, k), 0.5)
    return tsw._sweep_from_starts(from_numpy(np.asarray(gs, np.float64)), p0s, D, "deep_bw", steps, 0.05,
                                  refine_passes, D >= 4 if recycle is None else recycle, None, None)


# -- the batched U4_kak ------------------------------------------------------


def test_u4_kak_takes_a_batch():
    """A (2, 3, 19) batch equals the stacked per-element calls and
    jax.vmap(qmps_tpu.core.lie.U4_kak), both to 1e-12 at complex128."""
    p = np.random.default_rng(11).standard_normal((2, 3, 19))
    got = tlie.U4_kak(from_numpy(p))
    assert got.shape == (2, 3, 4, 4) and got.dtype == torch.complex128
    stacked = torch.stack([torch.stack([tlie.U4_kak(from_numpy(p[i, j])) for j in range(3)]) for i in range(2)])
    np.testing.assert_allclose(to_np(got), to_np(stacked), atol=1e-12)
    want = jax.vmap(jax.vmap(jlie.U4_kak))(jnp.asarray(p))
    np.testing.assert_allclose(to_np(got), np.asarray(want), atol=1e-12)


# -- the wall against JAX's --------------------------------------------------


@pytest.mark.parametrize("D", [2, 4, 8])
def test_walls_match_jax(D):
    """brick_wall_unitary and brick_wall_tensor at depth n + 1, a batch of
    three parameter rows against JAX's per row, to 1e-12 (reached ~6e-16)."""
    n = _n_qubits(D)
    p = np.random.default_rng(D).standard_normal((3, n_brick_params(n, n + 1)))
    U = brick_wall_unitary(from_numpy(p), n, n + 1)
    A = brick_wall_tensor(from_numpy(p), D, n + 1)
    assert U.shape == (3, 2 * D, 2 * D) and A.shape == (3, 2, D, D)
    for i in range(3):
        np.testing.assert_allclose(to_np(U[i]), np.asarray(jbd.brick_wall_unitary(jnp.asarray(p[i]), n, n + 1)),
                                   atol=1e-12)
        np.testing.assert_allclose(to_np(A[i]), np.asarray(jbd.brick_wall_tensor(jnp.asarray(p[i]), D, n + 1)),
                                   atol=1e-12)


# -- tests/test_deep_brickwork.py, ported --------------------------------------


def test_layout_alternates_and_covers():
    pairs = brick_layout(6, 6)
    # even layers start at wire 0, odd at wire 1; every wire is touched
    assert pairs[:3] == [(0, 1), (2, 3), (4, 5)]
    assert pairs[3:5] == [(1, 2), (3, 4)]
    assert {w for p in pairs for w in p} == set(range(6))
    assert n_brick_params(6, 6) == 19 * len(pairs)
    assert pairs == jbd.brick_layout(6, 6)


def test_wall_is_unitary():
    n, depth = 4, 3
    p = _normal(1, (n_brick_params(n, depth),), 1.0)
    U = to_np(brick_wall_unitary(p, n, depth))
    np.testing.assert_allclose(U.conj().T @ U, np.eye(2**n), atol=1e-10)


def test_tensor_left_canonical():
    D, depth = 8, 4
    A = to_np(brick_wall_tensor(_normal(2, (n_brick_params(4, depth),), 1.0), D, depth))
    assert A.shape == (2, D, D)
    acc = sum(A[s].conj().T @ A[s] for s in range(2))
    np.testing.assert_allclose(acc, np.eye(D), atol=1e-10)


def test_ops_face_matches_dense():
    """The IR face and the dense build agree (same wall, two compilers)."""
    n, depth = 3, 2
    p = _normal(3, (n_brick_params(n, depth),), 1.0)
    np.testing.assert_allclose(to_np(circuit_unitary(brick_wall_ops(p, n, depth), n)),
                               to_np(brick_wall_unitary(p, n, depth)), atol=1e-12)


def test_non_power_of_two_D_rejected():
    with pytest.raises(ValueError):
        brick_wall_tensor(torch.zeros(19, dtype=torch.float64), 6, 1)


def test_ground_state_D4():
    gs = ground_state_deep_brickwork(tfim(1.0), D=4, steps=300, lr=0.08, initial_guess=_normal(0, (76,), 0.3))
    e_exact = float(tfim_gs_energy_f64(1.0))
    assert gs.energy >= e_exact - 1e-6  # variational bound
    assert gs.energy - e_exact < 5e-3
    # reported energy is the returned state's energy
    assert abs(gs.energy - float(gs.history[-1])) < 1e-12
    # the returned tensor is a left-canonical (2, 4, 4) uMPS tensor
    A = to_np(gs.A)
    np.testing.assert_allclose(sum(A[s].conj().T @ A[s] for s in range(2)), np.eye(4), atol=1e-8)


@pytest.mark.slow
def test_ground_state_D8_krylov_path():
    """D = 8 rides the matvec Krylov environment on the CPU (the cold
    solver with dense_env_max_D = 4)."""
    n = n_brick_params(4, 5)
    gs = ground_state_deep_brickwork(tfim(0.8), D=8, steps=400, lr=0.06, initial_guess=_normal(5, (n,), 0.3),
                                     recycle=False, dense_env_max_D=4)
    e_exact = float(tfim_gs_energy_f64(0.8))
    assert gs.energy >= e_exact - 1e-6
    assert gs.energy - e_exact < 2e-3


def test_sweep_deep_bw_ansatz():
    """Config-4 sweep through the brick-wall ansatz at D = 4: the batched
    points track the exact integral."""
    gs = np.linspace(0.4, 1.6, 6)
    es, params = _sweep_from_jax_starts(gs, D=4, steps=200)
    assert params.shape == (6, n_brick_params(3, 4))
    err = to_np(es) - tfim_gs_energy_f64(gs)
    assert np.all(err > -1e-6)  # variational
    assert np.max(err) < 5e-3


def test_ground_state_recycled_matches_cold_D4():
    """Environment recycling (the default) converges to the same energy as
    the cold per-step solver from the same start."""
    x0 = _normal(1, (76,), 0.3)
    gr = ground_state_deep_brickwork(tfim(1.0), D=4, steps=200, initial_guess=x0, recycle=True)
    gc = ground_state_deep_brickwork(tfim(1.0), D=4, steps=200, initial_guess=x0, recycle=False)
    assert abs(gr.energy - gc.energy) < 1e-7
    # the reported energy is the returned state's (boosted final solve)
    assert abs(gr.energy - float(gr.history[-1])) < 1e-12
    assert gr.energy >= float(tfim_gs_energy_f64(1.0)) - 1e-9


def test_sweep_deep_bw_recycled_matches_cold():
    """The D >= 4 default (recycled) sweep is as accurate as the cold one:
    both variational, both on the exact integral, within 1e-3."""
    gs = np.linspace(0.5, 1.5, 4)
    exact = tfim_gs_energy_f64(gs)
    er, _ = _sweep_from_jax_starts(gs, D=4, steps=200, refine_passes=1)
    ec, _ = _sweep_from_jax_starts(gs, D=4, steps=200, refine_passes=1, recycle=False)
    for es in (er, ec):
        err = to_np(es) - exact
        assert np.all(err > -1e-6)  # variational (boosted final solve)
        assert np.max(err) < 5e-3
    assert np.max(np.abs(to_np(er) - to_np(ec))) < 1e-3


@pytest.mark.slow
def test_sweep_deep_bw_D16_gmres_backward():
    """D = 16: the sweep runs and stays variational (the port
    differentiates the warm iterations at every D, the JAX package
    through GMRES from D = 16)."""
    gs = np.array([0.7, 1.3])
    es, _ = _sweep_from_jax_starts(gs, D=16, steps=60)
    err = to_np(es) - tfim_gs_energy_f64(gs)
    assert np.all(np.isfinite(err))
    assert np.all(err > -1e-6)  # variational


# -- ground_state_deep_brickwork against JAX's -----------------------------------


@pytest.mark.parametrize("recycle", [False, True])
def test_ground_state_matches_jax(recycle):
    """Cold and recycled, D = 4, 20 steps from the same start: the
    history (energies 1e-8; reached ~5e-15) and the parameters
    (``assert_brick_params_match``) equal JAX's, and A up to a global phase."""
    x0 = np.asarray(jax.random.normal(jax.random.PRNGKey(4), (76,))) * 0.3
    t = ground_state_deep_brickwork(tfim(1.0), D=4, steps=20, initial_guess=from_numpy(x0), recycle=recycle)
    j = jax_ground_state_deep_brickwork(jax_tfim(1.0), D=4, steps=20, initial_guess=jnp.asarray(x0),
                                        recycle=recycle)
    assert t.history.shape == (21,) and t.params.dtype == torch.float64
    np.testing.assert_allclose(to_np(t.history), np.asarray(j.history), atol=1e-8)
    assert abs(t.energy - j.energy) < 1e-8
    assert_brick_params_match(t.params, j.params)
    A, Aj = to_np(t.A), np.asarray(j.A)
    ph = np.vdot(A, Aj) / abs(np.vdot(A, Aj))
    np.testing.assert_allclose(A * ph, Aj, atol=1e-8)


def test_cold_solver_knobs_raise_with_recycle():
    with pytest.raises(ValueError, match="recycle=False"):
        ground_state_deep_brickwork(tfim(1.0), D=4, steps=1, power_iters=10, device="cpu")
    with pytest.raises(ValueError, match="recycle=False"):
        ground_state_deep_brickwork(tfim(1.0), D=4, steps=1, dense_env_max_D=4, device="cpu")


def test_default_start_depth_and_precision():
    """depth n + 1 and a normal * 0.3 start from the generator (seed 0 if
    None); a float32 guess runs in float32 (the card's type)."""
    res = ground_state_deep_brickwork(tfim(1.0), D=4, steps=2, device="cpu")
    x0 = torch.randn(76, generator=torch.Generator().manual_seed(0), dtype=torch.float64) * 0.3
    again = ground_state_deep_brickwork(tfim(1.0), D=4, steps=2, initial_guess=x0)
    np.testing.assert_array_equal(to_np(res.params), to_np(again.params))
    f32 = ground_state_deep_brickwork(tfim(1.0), D=4, steps=2, initial_guess=x0.float())
    assert f32.params.dtype == torch.float32 and f32.A.dtype == torch.complex64


def test_u4_kak_dispatch_does_not_grow_with_the_batch():
    """All the bricks of a wall are one U4_kak call: its forward and
    backward dispatch the same operations for one brick as for a (64, 8)
    batch, at most 250 (reached: 200; -s prints them, and those of one
    sweep step of each kind)."""
    def u4(shape):
        p = torch.randn(shape + (19,), dtype=torch.float64, requires_grad=True)
        return lambda: (tlie.U4_kak(p).abs() ** 2).sum().backward()

    n1, n64 = dispatched(u4(())), dispatched(u4((64, 8)))
    assert n1 == n64 <= 250
    hs = tsw.tfim_matrix(torch.linspace(0.1, 2.0, 8, dtype=torch.float64))
    steps = {}
    for ansatz, D in (("suN", 2), ("suN", 4), ("deep_bw", 8), ("deep_bw", 16)):
        build, k = tsw._sweep_ansatz(ansatz, D)
        step_loss = tsw._chart_programs(build, D, 1, 0.05, D >= 4)[2]
        x = torch.zeros(8, k, dtype=torch.float64, requires_grad=True)
        steps[f"{ansatz} D = {D}"] = dispatched(lambda: step_loss(hs, x).backward())
    p = torch.zeros(8, n_brick_params(4, 5), dtype=torch.float64, requires_grad=True)
    wall = dispatched(lambda: (brick_wall_unitary(p, 4, 5).abs() ** 2).sum().backward())
    print(f"U4_kak forward and backward: {n64} operations; the D = 8 wall's: {wall}; a sweep step's loss and "
          f"backward: {steps}")
