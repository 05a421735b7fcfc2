"""qmps_torch's chart sweeps (sweep_ground_states, the grown sweep,
multi_start_ground_state, phase_diagram_sweep) against qmps_tpu's at
complex128 on the CPU, from the starts the JAX package draws (carried
across by utils/convert into the port's ``_sweep_from_starts`` and
``_grown_from_starts``), and the tests of tests/test_sweep.py that use no
mesh, ported with their sizes and bounds (the slow ones slow).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import assert_brick_params_match, to_np
from qmps_torch.ham.exact import tfim_gs_energy_f64
from qmps_torch.parallel import (
    multi_start_ground_state,
    phase_diagram_sweep,
    sweep_ground_states,
    sweep_ground_states_grown,
)
from qmps_torch.parallel import sweep as tsw
from qmps_torch.utils.convert import from_numpy
from qmps_tpu.parallel import sweep as jsw

KEY = jax.random.PRNGKey(0)


def _jax_starts(shape, key=KEY):
    """sweep_ground_states's starts: normal(key, (n, restarts, k)) * 0.5."""
    return from_numpy(jax.random.normal(key, shape)) * 0.5


def _jax_jitter(key=KEY):
    """The refine pass's noise: 0.05 normal(fold_in(key, 1000 + 2k + (shift > 0)))."""
    return lambda k, shift, shape: 0.05 * from_numpy(
        jax.random.normal(jax.random.fold_in(key, 1000 + 2 * k + (shift > 0)), shape))


def _sweep(gs, D=2, ansatz="suN", steps=300, restarts=1, refine_passes=0, recycle=None, point_chunk=None, key=KEY):
    """The port's sweep from JAX's starts and jitter."""
    _, k = tsw._sweep_ansatz(ansatz, D)
    p0s = _jax_starts((len(gs), restarts, k), key)
    return tsw._sweep_from_starts(from_numpy(np.asarray(gs, np.float64)), p0s, D, ansatz, steps, 0.05,
                                  refine_passes, D >= 4 if recycle is None else recycle, point_chunk,
                                  _jax_jitter(key))


def _grown(gs, D, steps, stage_steps=None, key=KEY):
    """The port's grown sweep from JAX's rung keys fold_in(key, i)."""
    starts = lambda i, shape: _jax_starts(shape, jax.random.fold_in(key, i))  # noqa: E731
    return tsw._grown_from_starts(from_numpy(np.asarray(gs, np.float64)), D, steps, 0.05, 1, 0, 2, stage_steps,
                                  4e-2, None, True, starts, lambda i: _jax_jitter(jax.random.fold_in(key, i)))


# -- against JAX's sweeps -----------------------------------------------------


@pytest.mark.parametrize("ansatz, D, n, steps, refine, restarts", [
    ("suN", 2, 8, 50, 1, 1),
    ("deep_bw", 4, 4, 20, 0, 1),
    ("full15", 2, 4, 30, 0, 1),
    ("deep_bw", 4, 4, 10, 1, 2),
])
def test_sweep_matches_jax(ansatz, D, n, steps, refine, restarts):
    """Energies and parameters from the same starts (and, with restarts
    2, the same refine jitter) to 1e-8 (reached ~1e-14; "deep_bw"'s phase
    coordinates and "full15"'s gauge parameter 0 move by rounding alone,
    within 1e-7)."""
    gs = np.linspace(0.3, 1.8, n)
    et, pt = _sweep(gs, D, ansatz, steps, restarts, refine)
    ej, pj = jsw.sweep_ground_states(jnp.asarray(gs), D=D, ansatz=ansatz, steps=steps, restarts=restarts,
                                     refine_passes=refine, key=KEY)
    assert et.shape == (n,) and pt.shape == tuple(pj.shape)
    np.testing.assert_allclose(to_np(et), np.asarray(ej), atol=1e-8)
    if ansatz == "deep_bw":
        assert_brick_params_match(pt, pj)
    elif ansatz == "full15":
        np.testing.assert_allclose(to_np(pt)[:, 1:], np.asarray(pj)[:, 1:], atol=1e-8)
        np.testing.assert_allclose(to_np(pt)[:, 0], np.asarray(pj)[:, 0], atol=1e-7)
    else:
        np.testing.assert_allclose(to_np(pt), np.asarray(pj), atol=1e-8)


def test_grown_sweep_matches_jax():
    """D 2 -> 4 from the same first-rung starts (the second rung's only
    slot is the embedding of the first): every rung's energies and
    parameters to 1e-8 (reached ~1e-14)."""
    gs = np.linspace(0.4, 1.8, 4)
    et, pt, st = _grown(gs, 4, steps=30, stage_steps=20)
    ej, pj, sj = jsw.sweep_ground_states_grown(jnp.asarray(gs), D=4, steps=30, stage_steps=20, key=KEY,
                                               return_stages=True)
    assert set(st) == set(sj) == {2, 4}
    for d in (2, 4):
        np.testing.assert_allclose(to_np(st[d][0]), np.asarray(sj[d][0]), atol=1e-8)
        np.testing.assert_allclose(to_np(st[d][1]), np.asarray(sj[d][1]), atol=1e-8)
    np.testing.assert_allclose(to_np(pt), np.asarray(pj), atol=1e-8)
    np.testing.assert_allclose(to_np(et), np.asarray(ej), atol=1e-8)


# -- tests/test_sweep.py, ported ------------------------------------------------


@pytest.mark.slow
def test_vmapped_sweep_energies():
    gs = np.linspace(0.2, 2.0, 8)
    es, params = _sweep(gs, D=2, steps=250)
    err = to_np(es) - tfim_gs_energy_f64(gs)
    assert np.all(err > -1e-8)
    assert np.max(err) < 5e-3


def test_multi_start_ground_state():
    e, p = multi_start_ground_state(1.0, D=2, ansatz="full15", n_starts=8, steps=200, device="cpu")
    assert float(e) - float(tfim_gs_energy_f64(1.0)) < 2e-2
    assert p.shape == (15,)


def test_phase_diagram_multi_D():
    """The JAX test without its mesh."""
    table = phase_diagram_sweep(torch.linspace(0.5, 1.5, 8, dtype=torch.float64), Ds=(2,), steps=150)
    assert table.shape == (1, 8)
    assert np.all(np.isfinite(to_np(table)))


def test_refine_passes_only_improve():
    """Adiabatic-continuation refinement never worsens any point and
    rescues bad basins (elementwise best is kept)."""
    gs = np.linspace(0.3, 1.8, 16)
    e0, _ = _sweep(gs, D=2, steps=100)
    e1, _ = _sweep(gs, D=2, steps=100, refine_passes=1)
    assert np.all(to_np(e1) <= to_np(e0) + 1e-12)
    assert np.max(to_np(e1) - tfim_gs_energy_f64(gs)) < 5e-3


def test_refine_verbatim_eval_mechanism():
    """(a) the refine pass's evaluator reproduces the optimizer's reported
    energy at the returned parameters (1e-5), and (b) a converged
    neighbour's parameters cost O(dg^2) here (median < 5e-3)."""
    gs = np.linspace(0.3, 1.8, 16)
    hs = tsw.tfim_matrix(from_numpy(gs))
    for D, steps in ((2, 100), (4, 150)):
        es, ps = _sweep(gs, D=D, steps=steps)
        build, _ = tsw._sweep_ansatz("suN", D)
        _, evaluate, _ = tsw._chart_programs(build, D, steps, 0.05, D >= 4)
        np.testing.assert_allclose(to_np(evaluate(hs, ps)), to_np(es), atol=1e-5)
        e_nb = to_np(evaluate(hs, torch.roll(ps, 1, 0)))
        interior = (e_nb - to_np(es))[1:]  # drop the wrap
        assert np.median(interior) < 5e-3, interior


@pytest.mark.slow
def test_grown_sweep_heals_bad_basins():
    """The D = 4 grown sweep is variational, at least as good pointwise as
    its own D = 2 rung (within 5e-4), and heals that rung's worst point."""
    gs = np.linspace(0.4, 1.8, 6)
    es4, ps4, stages = _grown(gs, 4, steps=200, stage_steps=200)
    assert set(stages) == {2, 4}
    exact = tfim_gs_energy_f64(gs)
    err = to_np(es4) - exact
    assert np.all(err > -1e-9), err
    assert np.max(err) < 2e-3, err
    e2 = to_np(stages[2][0])
    assert np.all(to_np(es4) <= e2 + 5e-4)
    assert np.max(err) < np.max(e2 - exact)
    assert ps4.shape == (6, 63)


# -- the port's own --------------------------------------------------------------


def test_point_chunk_changes_nothing():
    """Chunks of 3 points give the unchunked sweep's result exactly; on
    the CPU the default chunk is every point."""
    gs = np.linspace(0.5, 1.5, 7)
    e1, p1 = _sweep(gs, D=4, ansatz="deep_bw", steps=5, restarts=2, refine_passes=1)
    e2, p2 = _sweep(gs, D=4, ansatz="deep_bw", steps=5, restarts=2, refine_passes=1, point_chunk=3)
    np.testing.assert_allclose(to_np(e2), to_np(e1), atol=1e-12)
    np.testing.assert_allclose(to_np(p2), to_np(p1), atol=1e-12)
    assert tsw.chart_point_chunk(1024, 4, 10**6, "cpu") == 1024


def test_saved_bytes_count_the_unroll():
    """The chunk rule's row cost: autograd's saved bytes of one row grow
    with the warm iterations (the unroll stack)."""
    build, k = tsw._sweep_ansatz("deep_bw", 8)
    h = tsw.tfim_matrix(torch.ones(1, dtype=torch.float64))
    p = torch.zeros(1, k, dtype=torch.float64)
    b4, b24 = (tsw._saved_bytes(lambda x: tsw._chart_programs(build, 8, 1, 0.05, True, it)[2](h, x), p)
               for it in (4, 24))
    # at least SAVED_PER_ITER complex (D, D) tensors an iteration
    assert b24 - b4 >= 20 * tsw.SAVED_PER_ITER * 64 * 16


def test_public_sweep_generator_warm_params_and_precision():
    """The generator draws the starts (same seed, same result), warm
    params replace slot 0 (shape checked), a float32 gs runs in float32,
    and the grown sweep's ValueErrors."""
    gs = torch.linspace(0.5, 1.5, 3, dtype=torch.float64)
    a = sweep_ground_states(gs, D=2, steps=3, generator=torch.Generator().manual_seed(7))
    b = sweep_ground_states(gs, D=2, steps=3, generator=torch.Generator().manual_seed(7))
    np.testing.assert_array_equal(to_np(a[1]), to_np(b[1]))
    warm = sweep_ground_states(gs, D=2, steps=3, warm_params=a[1])
    assert warm[1].shape == (3, 15)
    with pytest.raises(ValueError, match="warm_params"):
        sweep_ground_states(gs, D=2, steps=3, warm_params=a[1][:2])
    es, ps = sweep_ground_states(gs.float(), D=4, ansatz="deep_bw", steps=2, restarts=2, refine_passes=1)
    assert es.dtype == torch.float32 and ps.dtype == torch.float32
    with pytest.raises(ValueError, match="powers of two"):
        sweep_ground_states_grown(gs, D=6, steps=2)
    with pytest.raises(ValueError, match="stage_steps"):
        sweep_ground_states_grown(gs, D=4, steps=2, stage_steps=0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        multi_start_ground_state(1.0, steps=1)
