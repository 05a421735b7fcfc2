"""qmps_torch's quench family (algorithms.evolve.batched_quench_sweep) and
ground-state search against qmps_tpu and the exact oracles: the same
initial parameters through both packages, the port's two engines against
each other, the exact Loschmidt rate over a short horizon
(test_evolve.py:36-47), the ground-state energy, the validation errors,
and the port's independence of JAX."""
import pkgutil
import subprocess
import sys
from pathlib import Path

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
    t_t, les_t = batched_quench_sweep(1.5, [0.2, 0.5], params0=torch.from_numpy(p0), engine="pallas", **SHORT)
    assert les_t.shape == (2, 3) and les_t.dtype == torch.float64
    np.testing.assert_allclose(to_np(t_t), np.asarray(t_j), atol=1e-15)
    np.testing.assert_allclose(to_np(les_t), np.asarray(les_j), atol=1e-8)


def test_port_engines_agree():
    p0 = torch.from_numpy(_params0())
    _, les_p = batched_quench_sweep(1.5, [0.2, 0.5], params0=p0, engine="pallas", **SHORT)
    _, les_d = batched_quench_sweep(1.5, [0.2, 0.5], params0=p0, engine="dense", **SHORT)
    np.testing.assert_allclose(to_np(les_p), to_np(les_d), atol=1e-10)


def test_quench_tracks_the_exact_rate():
    """Two trajectories from the port's own ground state of tfim(1.5)
    (250 L-BFGS steps), engine="pallas", 15 steps to t = 0.6 of 80 adam
    steps: the rate -log(overlap) within 0.02 of the exact one
    (test_evolve.py:36-47)."""
    times, les = batched_quench_sweep(
        1.5, [0.2, 0.4], t_max=0.6, n_steps=15, inner_steps=80, gs_steps=250, engine="pallas"
    )
    rates = -np.log(to_np(les))
    for j, g1 in enumerate([0.2, 0.4]):
        exact = loschmidt_rate(to_np(times), 1.5, g1)
        assert np.max(np.abs(rates[j] - exact)) < 0.02, g1


def test_find_ground_state_full15_lbfgs():
    """300 L-BFGS steps on tfim(1.5): the energy of the returned state at
    or above the exact one, within 5e-4 (the JAX package reaches 1.9e-4);
    the state's tensor is left-canonical."""
    gs = find_ground_state(tfim(1.5), D=2, ansatz="full15", method="lbfgs", steps=300)
    err = gs.energy - float(tfim_gs_energy_f64(1.5))
    assert -1e-9 < err < 5e-4, err
    assert gs.params.shape == (15,) and gs.U.shape == (4, 4)
    A = to_np(gs.A)
    np.testing.assert_allclose(np.einsum("sik,sij->kj", A.conj(), A), np.eye(2), atol=1e-12)


def test_find_ground_state_adam_descends():
    gs = find_ground_state(tfim(1.0), ansatz="full15", method="adam", steps=150)
    assert gs.history.shape == (150,) and gs.energy < float(gs.history[0])
    assert gs.energy - float(tfim_gs_energy_f64(1.0)) > -1e-9


def test_hamiltonian_matches_jax():
    for strings in ({"ZZ": -1.0, "X": 0.7}, {"XX": 1.0, "YY": 1.0, "Z": 0.3}):
        np.testing.assert_allclose(Hamiltonian(strings).to_matrix(), jham.Hamiltonian(strings).to_matrix(), atol=0)
    np.testing.assert_array_equal(as_host_matrix(tfim(1.5)), jham.as_host_matrix(jham.tfim(1.5)))


def test_engine_and_ansatz_validation():
    with pytest.raises(ValueError, match="engine"):
        batched_quench_sweep(1.5, [0.2], 0.1, 1, inner_steps=1, gs_steps=2, engine="palas")
    with pytest.raises(NotImplementedError, match="core/lie"):
        find_ground_state(tfim(1.0), ansatz="suN", steps=1)
    with pytest.raises(NotImplementedError, match="rotosolve"):
        find_ground_state(tfim(1.0), ansatz="full15", method="rotosolve", steps=1)


def test_port_never_imports_jax():
    """Importing every module of qmps_torch leaves jax and qmps_tpu out of
    sys.modules."""
    names = [m.name for m in pkgutil.walk_packages(qmps_torch.__path__, "qmps_torch.")]
    assert "qmps_torch.algorithms.evolve" in names and "qmps_torch.kernels.tdvp_fused" in names
    code = (
        "import importlib, sys\n"
        f"for m in {names!r}: importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'qmps_tpu'))]\n"
        "print(bad); sys.exit(1 if bad else 0)"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True)
    assert proc.returncode == 0, proc.stdout + proc.stderr
