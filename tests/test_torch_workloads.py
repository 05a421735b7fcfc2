"""qmps_torch.workloads: every configuration of the JAX package's
CONFIG_LADDER has its counterpart with the same fields, run() returns the
JAX config's keys, run_ladder writes a trace per config; and
tests/test_workloads.py's configs, ported at its tiny sizes (the slow ones
slow), on the CPU in float64.
"""
import dataclasses
import json
import os

import numpy as np
import pytest

from qmps_torch import workloads as tw
from qmps_torch.utils import profiling
from qmps_torch.utils.profiling import trace
from qmps_tpu import workloads as jw

#: the JAX configs' fields that are TPU workarounds (the scan chunk)
DROPPED = {"chunk"}

#: the keys each JAX config's run() returns (qmps_tpu/workloads.py)
SWEEP_KEYS = {"opts_per_sec", "seconds", "median_error", "max_error", "min_error"}
KEYS = {
    "GroundStateConfig": {"energy", "exact", "error", "seconds", "steps_per_sec"},
    "QuenchConfig": {"max_rate_error", "seconds", "tdvp_steps_per_sec"},
    "SweepConfig": SWEEP_KEYS,
    "FusedSweepConfig": SWEEP_KEYS,
    "GrownSweepConfig": SWEEP_KEYS,
    "StiefelSweepConfig": SWEEP_KEYS,
    "LargeDConfig": {"energy", "exact", "error", "best_seen", "seconds", "steps_per_sec"},
    "DeepBrickworkConfig": {"energy", "exact", "error", "n_params", "seconds", "steps_per_sec"},
}


def test_ladder_mirrors_jax():
    """The twelve entries in order: the same class, the same field values
    but the dropped TPU workarounds and the port's device and precision
    knobs."""
    assert len(tw.CONFIG_LADDER) == len(jw.CONFIG_LADDER) == 12
    for t, j in zip(tw.CONFIG_LADDER, jw.CONFIG_LADDER):
        assert type(t).__name__ == type(j).__name__
        jf = {f.name: getattr(j, f.name) for f in dataclasses.fields(j)}
        tf = {f.name: getattr(t, f.name) for f in dataclasses.fields(t)}
        assert {k: v for k, v in jf.items() if k not in DROPPED}.items() <= tf.items(), type(t).__name__
        assert set(tf) - set(jf) <= {"device", "precision", "polish_steps"}


@pytest.mark.parametrize("cfg", [
    tw.GroundStateConfig(D=2, steps=30, device="cpu"),
    tw.QuenchConfig(n_steps=2, inner_steps=10, device="cpu"),
    tw.SweepConfig(n_points=4, steps=10, device="cpu"),
    tw.SweepConfig(n_points=3, D=4, ansatz="deep_bw", steps=5, refine_passes=1, device="cpu"),
    tw.FusedSweepConfig(n_points=4, steps=10, restarts=2, device="cpu"),
    tw.GrownSweepConfig(n_points=3, D=4, steps=5, device="cpu"),
    tw.StiefelSweepConfig(n_points=3, D=4, steps=5, device="cpu"),
    tw.LargeDConfig(D=4, steps=5, device="cpu"),
    tw.DeepBrickworkConfig(D=4, steps=5, device="cpu"),
], ids=lambda c: type(c).__name__)
def test_run_returns_the_jax_keys(cfg):
    m = cfg.run()
    assert set(m) == KEYS[type(cfg).__name__]
    assert all(np.isfinite(v) for v in m.values())


def test_run_ladder_traces_each_config(tmp_path, monkeypatch):
    """run_ladder over two tiny configs names them <Class>_<i> and writes
    one Chrome trace each under profile_dir (or QMPS_PROFILE_DIR)."""
    cfgs = (tw.GroundStateConfig(D=2, steps=5, device="cpu"), tw.SweepConfig(n_points=2, steps=3, device="cpu"))
    out = tw.run_ladder(cfgs, profile_dir=str(tmp_path / "a"))
    assert list(out) == ["GroundStateConfig_0", "SweepConfig_1"]
    assert set(out["SweepConfig_1"]) == SWEEP_KEYS
    for name in out:
        with open(tmp_path / "a" / name / "trace.json") as f:
            assert json.load(f)["traceEvents"]
    monkeypatch.setenv("QMPS_PROFILE_DIR", str(tmp_path / "b"))
    tw.run_ladder(cfgs[:1])
    assert os.path.isfile(tmp_path / "b" / "GroundStateConfig_0" / "trace.json")


def test_trace_and_throughput():
    """``trace`` writes a Chrome trace with the program's spans among its
    events, on the file's own time base: each sweep step's span brackets the
    ``aten::`` operations of its step; spans are off again after it."""
    with trace() as d:
        pass
    assert os.path.isfile(os.path.join(d, "trace.json"))
    cfg = tw.FusedSweepConfig(n_points=2, steps=3, restarts=1, device="cpu")
    with trace() as d:
        cfg.sweep(cfg.grid())
    assert not profiling._on and profiling.drain_spans() == []
    with open(os.path.join(d, "trace.json")) as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    spans = [e for e in events if e.get("cat") == "span"]
    steps = sorted((e["ts"], e["ts"] + e["dur"]) for e in spans if e["name"] == "sweep.step")
    assert len(steps) == 3 and {e["name"] for e in spans} >= {"sweep.job", "sweep.init", "sweep.finish"}
    ops = [(e["ts"], e["ts"] + e["dur"]) for e in events if e["name"].startswith("aten::") and e.get("cat") != "span"]
    for a, b in steps:
        inside = [o for o in ops if a <= o[0] and o[1] <= b]
        assert inside, (a, b)
        # an operation that starts in a step ends in it: the spans share the trace's clock
        assert all(o[1] <= b for o in ops if a <= o[0] < b)


# -- tests/test_workloads.py, ported ----------------------------------------------


def test_ground_state_config():
    m = tw.GroundStateConfig(D=2, steps=150, device="cpu").run()
    assert m["error"] < 5e-3 and m["error"] > -1e-8


def test_brickwork_config():
    m = tw.BrickworkConfig(batch=1024, iters=3, device="cpu").run()
    assert m["overlap_evals_per_sec"] > 0


@pytest.mark.slow
def test_sweep_config():
    m = tw.SweepConfig(n_points=16, steps=300, device="cpu").run()
    assert m["max_error"] < 5e-2
    assert np.isfinite(m["opts_per_sec"])


def test_stiefel_sweep_config():
    m = tw.StiefelSweepConfig(n_points=4, D=4, steps=120, device="cpu").run()
    assert m["max_error"] < 5e-3
    assert m["median_error"] > -1e-6  # variational: never below exact
    assert np.isfinite(m["opts_per_sec"])


@pytest.mark.slow
def test_large_d_config():
    m = tw.LargeDConfig(D=16, steps=200, device="cpu").run()
    assert m["error"] < 5e-3 and m["error"] > -1e-8


@pytest.mark.slow
def test_fused_sweep_config():
    m = tw.FusedSweepConfig(n_points=8, steps=60, restarts=1, device="cpu").run()
    assert np.isfinite(m["opts_per_sec"])
    assert m["max_error"] < 5e-2
