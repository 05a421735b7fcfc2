"""qmps_torch's quench family (algorithms.evolve.batched_quench_sweep) and
ground-state search against qmps_tpu and the exact oracles: the same
initial parameters through both packages, the port's two engines against
each other, the exact Loschmidt rate over a short horizon
(test_evolve.py:36-47), the ground-state energy, the validation errors,
and the port's independence of JAX."""
import json
import os
import pkgutil
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import qmps_torch
from _torch_parity import to_np
from qmps_torch.algorithms.evolve import batched_quench_sweep
from qmps_torch.algorithms.ground_state import find_ground_state
from qmps_torch.ham.exact import loschmidt_rate, tfim_gs_energy_f64
from qmps_torch.ham.hamiltonian import Hamiltonian, as_host_matrix, tfim
from qmps_tpu.algorithms import evolve as jevolve
from qmps_tpu.ham import hamiltonian as jham

REPO = Path(__file__).resolve().parent.parent
SHORT = dict(t_max=0.1, n_steps=3, inner_steps=10)


def _params0():
    return np.random.default_rng(0).standard_normal(15) * 0.5


def test_pallas_engine_matches_jax_dense_engine():
    """From the same initial parameters, the port's engine="pallas" (the
    plain K4/K5 on the CPU, complex128) against JAX's engine="dense":
    g1 in [0.2, 0.5], 3 steps of 10 adam steps; overlaps to 1e-8."""
    p0 = _params0()
    t_j, les_j = jevolve.batched_quench_sweep(1.5, [0.2, 0.5], params0=jnp.asarray(p0), **SHORT)
    t_t, les_t = batched_quench_sweep(1.5, [0.2, 0.5], params0=torch.from_numpy(p0), engine="pallas",
                                      device="cpu", **SHORT)
    assert les_t.shape == (2, 3) and les_t.dtype == torch.float64
    np.testing.assert_allclose(to_np(t_t), np.asarray(t_j), atol=1e-15)
    np.testing.assert_allclose(to_np(les_t), np.asarray(les_j), atol=1e-8)


def test_port_engines_agree():
    p0 = torch.from_numpy(_params0())
    _, les_p = batched_quench_sweep(1.5, [0.2, 0.5], params0=p0, engine="pallas", device="cpu", **SHORT)
    _, les_d = batched_quench_sweep(1.5, [0.2, 0.5], params0=p0, engine="dense", device="cpu", **SHORT)
    np.testing.assert_allclose(to_np(les_p), to_np(les_d), atol=1e-10)


def test_quench_tracks_the_exact_rate():
    """Two trajectories from the port's own ground state of tfim(1.5)
    (250 L-BFGS steps), engine="pallas", 15 steps to t = 0.6 of 80 adam
    steps: the rate -log(overlap) within 0.02 of the exact one
    (test_evolve.py:36-47)."""
    times, les = batched_quench_sweep(
        1.5, [0.2, 0.4], t_max=0.6, n_steps=15, inner_steps=80, gs_steps=250, engine="pallas",
        device="cpu",
    )
    rates = -np.log(to_np(les))
    for j, g1 in enumerate([0.2, 0.4]):
        exact = loschmidt_rate(to_np(times), 1.5, g1)
        assert np.max(np.abs(rates[j] - exact)) < 0.02, g1


def test_find_ground_state_full15_lbfgs():
    """300 L-BFGS steps on tfim(1.5): the energy of the returned state at
    or above the exact one, within 5e-4 (the JAX package reaches 1.9e-4);
    the state's tensor is left-canonical."""
    gs = find_ground_state(tfim(1.5), D=2, ansatz="full15", method="lbfgs", steps=300, device="cpu")
    err = gs.energy - float(tfim_gs_energy_f64(1.5))
    assert -1e-9 < err < 5e-4, err
    assert gs.params.shape == (15,) and gs.U.shape == (4, 4)
    A = to_np(gs.A)
    np.testing.assert_allclose(np.einsum("sik,sij->kj", A.conj(), A), np.eye(2), atol=1e-12)


def test_find_ground_state_adam_descends():
    gs = find_ground_state(tfim(1.0), ansatz="full15", method="adam", steps=150, device="cpu")
    assert gs.history.shape == (150,) and gs.energy < float(gs.history[0])
    assert gs.energy - float(tfim_gs_energy_f64(1.0)) > -1e-9


def test_hamiltonian_matches_jax():
    for strings in ({"ZZ": -1.0, "X": 0.7}, {"XX": 1.0, "YY": 1.0, "Z": 0.3}):
        np.testing.assert_allclose(Hamiltonian(strings).to_matrix(), jham.Hamiltonian(strings).to_matrix(), atol=0)
    np.testing.assert_array_equal(as_host_matrix(tfim(1.5)), jham.as_host_matrix(jham.tfim(1.5)))


def test_engine_and_ansatz_validation():
    """The default ansatz "suN" and the shallow circuit ansatze run, and
    equal JAX's energy at the same parameters (1e-10); an unknown ansatz
    and an unknown method raise; rotosolve, a ported method now, runs
    (tests/test_torch_optimizers.py holds it to JAX's)."""
    from qmps_tpu.circuits import ansatze as jans
    from qmps_tpu.objectives import energy as jenergy

    with pytest.raises(ValueError, match="engine"):
        batched_quench_sweep(1.5, [0.2], 0.1, 1, inner_steps=1, gs_steps=2, engine="palas", device="cpu")
    h = jnp.asarray(tfim(1.0).to_matrix())
    p0 = np.random.default_rng(1).standard_normal(15) * 0.5
    gs = find_ground_state(tfim(1.0), steps=1, initial_guess=torch.from_numpy(p0))
    e_j = jenergy.energy_exact_env(jans.full_state_suN(jnp.asarray(np.asarray(gs.params)), 2), h)
    assert abs(gs.energy - float(e_j)) < 1e-10
    for ansatz, n in (("qaoa", 4), ("cnot", 4), ("cnot3", 6), ("cnot_nonuniform", 8), ("exact_after_4", 12)):
        p0 = np.random.default_rng(2).standard_normal(n) * 0.5
        gs = find_ground_state(tfim(1.0), ansatz=ansatz, steps=1, initial_guess=torch.from_numpy(p0))
        e_j = jenergy.energy_exact_env(jans.STATE_ANSATZE[ansatz](2, jnp.asarray(np.asarray(gs.params))), h)
        assert abs(gs.energy - float(e_j)) < 1e-10, ansatz
    with pytest.raises(ValueError, match="unknown ansatz"):
        find_ground_state(tfim(1.0), ansatz="sun", steps=1, device="cpu")
    with pytest.raises(ValueError, match="nope"):
        find_ground_state(tfim(1.0), ansatz="full15", method="nope", steps=1, device="cpu")
    gs = find_ground_state(tfim(1.0), ansatz="full15", method="rotosolve", steps=10, device="cpu")
    assert np.isfinite(gs.energy) and gs.history.shape == (1,)


def test_float32_params0_runs_the_quench_in_float32():
    """A float32 ``params0`` makes the quench run in float32 on the CPU (the
    card's precision); a float64 or numpy one keeps the device's float64."""
    p0 = _params0()
    kw = dict(engine="pallas", device="cpu", t_max=0.02, n_steps=1, inner_steps=2)
    t32, les32 = batched_quench_sweep(1.5, [0.2, 0.5], params0=torch.from_numpy(p0).float(), **kw)
    _, les_g = batched_quench_sweep(1.5, torch.tensor([0.2, 0.5], dtype=torch.float32), params0=p0, **kw)
    _, les64 = batched_quench_sweep(1.5, [0.2, 0.5], params0=p0, **kw)
    assert t32.dtype == les32.dtype == les_g.dtype == torch.float32 and les64.dtype == torch.float64
    np.testing.assert_allclose(to_np(les32), to_np(les64), atol=1e-5)


# the quench of chip_smoke.py phase 7 cut to the five smallest of its 64
# couplings (where the float32 and float64 maxima lie), to t = 0.6
_Q32_G1 = np.linspace(0.1, 0.4, 64)[:5]
_Q32_GRID = dict(t_max=0.6, n_steps=30, inner_steps=80, lr=3e-2, engine="pallas", pallas_iters=48)
_JAX_F32_QUENCH = """
import json, os, sys
os.environ["QMPS_TPU_X64"] = "0"
import jax
jax.config.update("jax_platforms", "cpu")
import numpy as np
import jax.numpy as jnp
from qmps_tpu.algorithms.evolve import batched_quench_sweep
p0, g1, grid = json.loads(sys.argv[1])
_, les = batched_quench_sweep(1.5, jnp.asarray(g1, jnp.float32), params0=jnp.asarray(p0, jnp.float32), **grid)
les = np.asarray(les)
print(json.dumps([str(les.dtype), les.astype(np.float64).tolist()]))
"""


def test_float32_quench_gap_is_the_method():
    """Classifies the float32 quench's larger rate error.  From the same
    float32 start (the port's float64 L-BFGS ground state of tfim(1.5),
    rounded), the JAX package in float32 (x64 off, engine="pallas" in
    interpret mode, a subprocess) and the port in float32 on the CPU (the
    plain K4/K5 in complex64) miss the exact Loschmidt rate alike: their
    largest errors agree to 1.5e-3 (on this cut 9.474e-3 both, float64
    8.976e-3), and the per-point scatter of each about the port's float64
    rates has the same size (rms 4.9e-4 both).  On the full 64 x 30 x 80
    grid on the CPU: JAX float32 9.47e-3, port float32 1.021e-2, float64
    8.976e-3, the float32 runs' rates differing by up to 2.8e-3 at a point;
    the card's 0.0122 lies inside that scatter.  The subprocess runs
    without the suite's cheap-codegen XLA flags (interpret mode runs
    several times slower under them) and shares its compilation cache."""
    gs = find_ground_state(tfim(1.5), D=2, ansatz="full15", method="lbfgs", steps=300, device="cpu")
    p32 = gs.params.detach().float()
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    if jax.config.jax_compilation_cache_dir:
        env.update(JAX_COMPILATION_CACHE_DIR=jax.config.jax_compilation_cache_dir,
                   JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS="0.2")
    args = json.dumps([p32.tolist(), _Q32_G1.tolist(), _Q32_GRID])
    jax_run = subprocess.Popen([sys.executable, "-c", _JAX_F32_QUENCH, args], cwd=REPO, env=env,
                               stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        times, les32 = batched_quench_sweep(1.5, torch.from_numpy(_Q32_G1), params0=p32, device="cpu", **_Q32_GRID)
        _, les64 = batched_quench_sweep(1.5, torch.from_numpy(_Q32_G1), params0=gs.params, device="cpu",
                                        **_Q32_GRID)
        out, err = jax_run.communicate(timeout=600)
    finally:
        jax_run.kill()
        jax_run.wait()
    assert jax_run.returncode == 0, err[-3000:]
    jax_dtype, les_j = json.loads(out.strip().splitlines()[-1])
    assert jax_dtype == "float32" and les32.dtype == torch.float32 and les64.dtype == torch.float64
    t = to_np(times).astype(np.float64)
    exact = np.stack([loschmidt_rate(t, 1.5, g) for g in _Q32_G1])
    rate = {"port32": -np.log(to_np(les32).astype(np.float64)), "jax32": -np.log(np.asarray(les_j)),
            "port64": -np.log(to_np(les64))}
    worst = {k: np.abs(r - exact).max() for k, r in rate.items()}
    rms = {k: np.sqrt(np.mean((rate[k] - rate["port64"]) ** 2)) for k in ("port32", "jax32")}
    print(f"max |rate - exact|: {worst}; rms float32 - float64: {rms}")
    np.testing.assert_allclose(worst["port64"], 8.976e-3, atol=1e-5)
    assert worst["port32"] < 0.02 and worst["jax32"] < 0.02
    assert abs(worst["port32"] - worst["jax32"]) < 1.5e-3
    assert 0.5 < rms["port32"] / rms["jax32"] < 2.0 and max(rms.values()) < 2e-3


@pytest.mark.parametrize("entry", ["find_ground_state", "sweep_ground_states_fused", "batched_quench_sweep",
                                   "MPSTimeEvolve.evolve", "loschmidt_echo_run", "compile_state_to_ansatz",
                                   "sweep_ground_states_stiefel", "sweep_variance_certificates",
                                   "ground_state_riemannian", "vumps_ground_state",
                                   "vumps_ground_state_converged", "vumps_ground_state_mpo",
                                   "variance_certificate", "Trajectory", "dispersion", "minimize_scipy",
                                   "minimize_bayesian", "batched_noise_sweep", "noisy_loschmidt_echo_run",
                                   "NoisyNonSparseFullEnergyOptimizer"])
def test_entry_points_default_to_the_card(entry, monkeypatch):
    """Called without ``device`` on floats, lists or arrays, an entry point
    asks for the card and, on a machine without one, raises before it
    computes anything on the CPU."""
    from qmps_torch.algorithms import NoisyNonSparseFullEnergyOptimizer
    from qmps_torch.algorithms.evolve import (MPSTimeEvolve, batched_noise_sweep, compile_state_to_ansatz,
                                              loschmidt_echo_run, noisy_loschmidt_echo_run)
    from qmps_torch.mps import tdvp
    from qmps_torch.mps.excitations import dispersion
    from qmps_torch.mps.mpo import mpo_tfim, vumps_ground_state_mpo
    from qmps_torch.optim.minimize import minimize_bayesian, minimize_scipy
    from qmps_torch.optim.riemann import ground_state_riemannian
    from qmps_torch.parallel.sweep import (sweep_ground_states_fused, sweep_ground_states_stiefel,
                                           sweep_variance_certificates)

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    calls = {
        "find_ground_state": lambda: find_ground_state(tfim(1.0), ansatz="full15", steps=1),
        "sweep_ground_states_fused": lambda: sweep_ground_states_fused([0.5, 1.0], steps=1),
        "batched_quench_sweep": lambda: batched_quench_sweep(1.5, [0.2], 0.1, 1, inner_steps=1,
                                                             params0=np.zeros(15)),
        "MPSTimeEvolve.evolve": lambda: MPSTimeEvolve(tfim(0.5), 0.05, inner_steps=1).evolve(np.zeros(15), 1),
        "loschmidt_echo_run": lambda: loschmidt_echo_run(1.5, 0.2, 0.1, 1, inner_steps=1, gs_steps=1),
        "compile_state_to_ansatz": lambda: compile_state_to_ansatz(np.eye(4)[:, :2].reshape(2, 2, 2).copy(),
                                                                   steps=1),
        "sweep_ground_states_stiefel": lambda: sweep_ground_states_stiefel([0.5, 1.0], D=4, steps=1),
        "sweep_variance_certificates": lambda: sweep_variance_certificates(
            [1.0], np.eye(8)[:, :4].reshape(1, 4, 2, 4).transpose(0, 2, 1, 3), np.eye(4)[None] / 2),
        "ground_state_riemannian": lambda: ground_state_riemannian(tfim(1.0).to_matrix(), 4, steps=1),
        "vumps_ground_state": lambda: tdvp.vumps_ground_state(tfim(1.0).to_matrix(), 4, iters=1),
        "vumps_ground_state_converged": lambda: tdvp.vumps_ground_state_converged(tfim(1.0), 4, chunk_iters=1,
                                                                                  max_iters=1),
        "vumps_ground_state_mpo": lambda: vumps_ground_state_mpo(mpo_tfim(1.0), 4, iters=1),
        "variance_certificate": lambda: tdvp.variance_certificate(
            np.eye(4)[:, :2].reshape(2, 2, 2).copy(), tfim(1.0).to_matrix()),
        "Trajectory": lambda: tdvp.Trajectory(np.ones((2, 2, 2)), tfim(0.5)).eulerint(0.1, 1),
        "dispersion": lambda: dispersion(tfim(1.5).to_matrix(), 4, [0.0], iters=1),
        "minimize_scipy": lambda: minimize_scipy(lambda x: (x**2).sum(), np.zeros(2), maxiter=1),
        "minimize_bayesian": lambda: minimize_bayesian(lambda x: (x**2).sum(), [(-1.0, 1.0)] * 2, n_calls=2,
                                                       n_init=1),
        "batched_noise_sweep": lambda: batched_noise_sweep(1.5, 0.2, 0.1, 1, [0.0, 1e-3], inner_steps=1,
                                                           gs_steps=1),
        "noisy_loschmidt_echo_run": lambda: noisy_loschmidt_echo_run(1.5, 0.2, 0.1, 1, [0.0, 1e-3], inner_steps=1,
                                                                     gs_steps=1),
        "NoisyNonSparseFullEnergyOptimizer": lambda: NoisyNonSparseFullEnergyOptimizer(tfim(1.0), 1e-3),
    }
    with pytest.raises(RuntimeError, match="no CUDA device"):
        calls[entry]()


def test_port_never_imports_jax():
    """Importing every module of qmps_torch leaves jax and qmps_tpu out of
    sys.modules."""
    names = [m.name for m in pkgutil.walk_packages(qmps_torch.__path__, "qmps_torch.")]
    assert {"qmps_torch.algorithms.evolve", "qmps_torch.kernels.tdvp_fused",
            "qmps_torch.algorithms.brickwork_tdvp", "qmps_torch.kernels.brickwork_pallas",
            "qmps_torch.core.lie", "qmps_torch.env.variational", "qmps_torch.workloads",
            "qmps_torch.utils.checkpoint", "qmps_torch.utils.logging", "qmps_torch.utils.host_eval",
            "qmps_torch.utils.convert", "qmps_torch.core.linalg", "qmps_torch.core.gates",
            "qmps_torch.embed.unitaries", "qmps_torch.circuits.ansatze", "qmps_torch.circuits.brickwork",
            "qmps_torch.mps.imps", "qmps_torch.ham.hamiltonian", "qmps_torch.objectives.overlap",
            "qmps_torch.core.krylov", "qmps_torch.optim.riemann", "qmps_torch.mps.tdvp",
            "qmps_torch.parallel.sweep", "qmps_torch.mps.mpo", "qmps_torch.mps.excitations",
            "qmps_torch.ham.exact", "qmps_torch.ham.classical_baselines", "qmps_torch.circuits.brickwork_deep",
            "qmps_torch.utils.profiling"} <= set(names)
    code = (
        "import importlib, sys\n"
        f"for m in {names!r}: importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'qmps_tpu'))]\n"
        "print(bad); sys.exit(1 if bad else 0)"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True)
    assert proc.returncode == 0, proc.stdout + proc.stderr
