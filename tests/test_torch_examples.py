"""The port's examples (qmps_torch/examples/, one for each script of
examples/), run through ``main(device="cpu")`` in float64, each checked
on its headline numbers.  Those that take more than a few seconds on one
CPU thread are ``slow``; the card runs them all."""
import importlib

import numpy as np
import pytest

import _torch_parity  # noqa: F401  (one torch thread per worker)


def _scars_poincare(out):
    assert out["max_angle_deviation"] < 0.05  # tests/test_scars.py:44-57's bound
    assert len(out["crossings"]) == 16


def _power_method(out):
    assert out[64] < 1e-10 and out[1] > out[8] > out[32]


def _tour(out):
    assert all(v < 1e-10 for v in out["tomography_mismatch"].values()) or out["tomography_mismatch"]["exact"] < 1e-10
    assert all(0 < e < 1e-3 for e in out["energy_errors"].values())
    assert out["loschmidt_min"] > 0.999


def _bond_dimension(out):
    assert out[8] < out[4] < out[2] and out[8] > -4 / np.pi - 1e-9


def _central_charge(out):
    assert abs(out["c_ising"] - 0.5) < 0.05 and 0.8 < out["c_xy"] < 1.1


def _dispersion(out):
    assert out["max_dispersion_error"] < 1e-9  # the JAX example's: 6.8e-11
    assert all(w > 0 for w in out["weights"].values())


def _entanglement_growth(out):
    assert out["S_final"] > out["S0"] > 0


def _env_sensitivity(out):
    assert out["c2_mixed"] < 5.0


def _large_bond_dimension(out):
    assert all(0 < e < 1e-2 for e in out.values())


def _loschmidt_quench(out):
    assert out["classical_max_error"] < 0.05 and out["circuit_max_error"] < 0.1


def _neel_order(out):
    """D = 8 limits delta = 1.5 (the JAX example's 1.7e-4 and 1.5e-2); the
    gaps close as delta grows."""
    gaps = [out[d] for d in sorted(out)]
    assert all(abs(de) < 2e-4 and abs(dm) < 2e-2 for de, dm in gaps)
    assert all(abs(a[0]) > abs(b[0]) and abs(a[1]) > abs(b[1]) for a, b in zip(gaps, gaps[1:]))


def _neel_quench(out):
    assert out["max_diff"] < 3e-2


def _noisy_loschmidt(out):
    assert out["noiseless_max_error"] < 0.02


def _phase_diagram(out):
    assert out["suN_max_error"] < 5e-3 and out["fused_max_error"] < 5e-3 and out["grown_max_error"] < 5e-3


def _variance_extrapolation(out):
    assert abs(out["extrapolated_error"]) < abs(out["largest_D_error"])


CHECKS = {name[1:]: f for name, f in dict(globals()).items() if name.startswith("_") and callable(f)
          and not name.startswith("__") and name != "_torch_parity"}
#: the examples that finish within a few seconds on one CPU thread
FAST = {"power_method", "scars_poincare", "large_bond_dimension"}


@pytest.mark.parametrize("name", [n if n in FAST else pytest.param(n, marks=pytest.mark.slow) for n in sorted(CHECKS)])
def test_example_runs_on_the_cpu(name):
    mod = importlib.import_module(f"qmps_torch.examples.{name}")
    CHECKS[name](mod.main("cpu"))


def test_every_jax_example_has_its_port():
    import pathlib

    repo = pathlib.Path(__file__).resolve().parents[1]
    jax_examples = {p.stem for p in (repo / "examples").glob("*.py")}
    assert jax_examples == set(CHECKS)
    assert jax_examples == {p.stem for p in (repo / "qmps_torch" / "examples").glob("*.py")} - {"__init__"}
