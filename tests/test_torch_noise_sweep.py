"""qmps_torch's noisy evolve (algorithms.evolve: NoisyMPSTimeEvolve,
batched_noise_sweep, noisy_loschmidt_echo_run) against qmps_tpu at
complex128: the sweep from the same start, 2 levels x 2 outer x 5 inner
steps, to 1e-8; the noisy stepper against the sweep's rows; the p = 0 row
of the per-level run against loschmidt_echo_run; and the operations one
inner step of the sweep dispatches (the superoperator channel), which do
not grow with the number of levels."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import dispatched, to_np
from qmps_torch.algorithms import evolve as tev
from qmps_torch.ham.hamiltonian import tfim

LEVELS = [0.0, 1e-2]


@pytest.fixture(scope="module")
def jax_sweep():
    """JAX's batched_noise_sweep (1.5 -> 0.2, t_max 0.04, 2 outer steps of 5
    inner, levels 0 and 1e-2) from the start p0: its ground-state search
    is handed p0, so both packages start from the same parameters."""
    import qmps_tpu.algorithms.ground_state as jgs
    from qmps_tpu.algorithms import evolve as jev

    p0 = np.random.default_rng(3).standard_normal(15) * 0.4

    class _GS:
        params = jnp.asarray(p0)

    mp = pytest.MonkeyPatch()
    mp.setattr(jgs, "find_ground_state", lambda *a, **k: _GS())
    try:
        times, rates = jev.batched_noise_sweep(1.5, 0.2, 0.04, 2, LEVELS, inner_steps=5)
    finally:
        mp.undo()
    return p0, np.asarray(times), np.asarray(rates)


def test_noise_sweep_matches_jax_from_its_start(jax_sweep):
    p0, tj, rj = jax_sweep
    times, rates, ps = tev._noise_sweep_from(torch.from_numpy(p0), 0.2, 0.04, 2, LEVELS, inner_steps=5)
    assert rates.shape == (2, 2) and rates.dtype == torch.float64 and ps.shape == (2, 15)
    np.testing.assert_allclose(to_np(times), tj, rtol=0, atol=1e-15)
    np.testing.assert_allclose(to_np(rates), rj, rtol=0, atol=1e-8)


def test_noisy_stepper_follows_the_sweeps_rows(jax_sweep):
    """``NoisyMPSTimeEvolve``, 2 steps of 5 inner steps from p0, gives JAX's
    sweep rows at p = 0 and 1e-2: the stepper's objective hook is the
    sweep's objective, one level at a time (at p = 0 that is -sqrt(|x|),
    not ``MPSTimeEvolve``'s -|x|: adam follows another path)."""
    p0, _, rj = jax_sweep
    dt = 0.04 / 2
    for k, p in enumerate(LEVELS):
        rec = tev.NoisyMPSTimeEvolve(tfim(0.2), dt, p, inner_steps=5).evolve(torch.from_numpy(p0), 2)
        np.testing.assert_allclose(to_np(-torch.log(rec.loschmidt)), rj[k], rtol=0, atol=1e-8)
    st = tev.NoisyMPSTimeEvolve(tfim(0.2), dt, 1e-2, inner_steps=5)
    p1, err = st.step(torch.from_numpy(p0))
    with torch.no_grad():
        A = st.tensor(torch.from_numpy(p0))
        W = torch.from_numpy(st.W)
        np.testing.assert_allclose(err.item(), st.objective(A, st.tensor(p1), W).item(), rtol=0, atol=1e-15)


def test_p0_row_of_the_per_level_run_is_the_noiseless_echo():
    """``noisy_loschmidt_echo_run``'s p = 0 row is ``loschmidt_echo_run``'s
    rate (the same stepper), and the noisy rows are finite."""
    g = torch.Generator().manual_seed(2)
    t, rates = tev.noisy_loschmidt_echo_run(1.5, 0.2, 0.04, 2, [0.0, 3e-2], inner_steps=5, gs_steps=30,
                                            generator=g, device="cpu")
    t2, r2, _ = tev.loschmidt_echo_run(1.5, 0.2, 0.04, 2, inner_steps=5, gs_steps=30,
                                       generator=torch.Generator().manual_seed(2), device="cpu")
    assert rates.shape == (2, 2) and bool(torch.isfinite(rates).all())
    np.testing.assert_allclose(to_np(rates[0]), to_np(r2), rtol=0, atol=1e-14)
    np.testing.assert_allclose(to_np(t), to_np(t2), rtol=0, atol=1e-15)


def test_batched_noise_sweep_runs_from_its_ground_state():
    """The public sweep: the ground state of tfim(g0) from the generator,
    then ``_noise_sweep_from``; a float32 ``noise_levels`` tensor runs it
    in float32."""
    from qmps_torch.algorithms.ground_state import find_ground_state

    kw = dict(inner_steps=3, gs_steps=20)
    t, rates = tev.batched_noise_sweep(1.5, 0.2, 0.02, 1, [0.0, 1e-2], generator=torch.Generator().manual_seed(0),
                                       device="cpu", **kw)
    gs = find_ground_state(tfim(1.5), D=2, ansatz="full15", method="lbfgs", steps=20,
                           generator=torch.Generator().manual_seed(0), device="cpu")
    _, want, _ = tev._noise_sweep_from(gs.params, 0.2, 0.02, 1, [0.0, 1e-2], inner_steps=3)
    np.testing.assert_allclose(to_np(rates), to_np(want), rtol=0, atol=1e-15)
    _, r32 = tev.batched_noise_sweep(1.5, 0.2, 0.02, 1, torch.tensor([0.0, 1e-2]), device="cpu", **kw)
    assert r32.dtype == torch.float32 and bool(torch.isfinite(r32).all())


def test_inner_step_dispatch_does_not_grow_with_the_levels():
    """One inner step of the sweep (the summed noisy objective of L levels,
    forward and backward) dispatches as many operations for L = 5 as for
    L = 1 (one more: a broadcast), under 1,000: the channel is one product
    a qubit and a moment (6 x 11 of them), where the JAX package's literal
    loop makes 3 gate conjugations a qubit and a moment (-s prints the
    count)."""
    from qmps_torch.circuits.ansatze import shallow_full_state
    from qmps_torch.embed.unitaries import unitary_to_tensor
    from qmps_torch.objectives.noise import noisy_tdvp_objective

    W = torch.linalg.matrix_exp(-0.04j * torch.from_numpy(tfim(0.2).to_matrix()))

    def step(L):
        p = torch.from_numpy(np.random.default_rng(0).standard_normal((L, 15)) * 0.4).requires_grad_()
        levels = torch.linspace(0, 3e-2, L, dtype=torch.float64)
        with torch.no_grad():
            A = unitary_to_tensor(shallow_full_state(p))
        return lambda: noisy_tdvp_objective(A, unitary_to_tensor(shallow_full_state(p)), W, levels).sum().backward()

    n1, n5 = dispatched(step(1)), dispatched(step(5))
    print(f"one inner step of the noise sweep, forward and backward: {n5} operations (L = 5), {n1} (L = 1)")
    assert n1 <= n5 <= n1 + 1 < 1000


@pytest.mark.slow
def test_matches_sequential_and_noise_stalls():
    """tests/test_capabilities.py:159-183 on the port: the p = 0 row agrees
    with the sequential noiseless stepper to 2e-2, and strong noise stalls
    the trajectory below the clean curve."""
    g = torch.Generator().manual_seed(0)
    times, rates = tev.batched_noise_sweep(1.5, 0.2, 0.4, 5, [0.0, 3e-3, 3e-2], inner_steps=50, gs_steps=250,
                                           generator=g, device="cpu")
    r = to_np(rates)
    assert r.shape == (3, 5) and np.all(np.isfinite(r))
    _, r2, _ = tev.loschmidt_echo_run(1.5, 0.2, 0.4, 5, inner_steps=50, gs_steps=250,
                                      generator=torch.Generator().manual_seed(0), device="cpu")
    np.testing.assert_allclose(r[0], to_np(r2), atol=2e-2)
    assert r[2, -1] < r[0, -1]
