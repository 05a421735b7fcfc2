"""The benchmark's run of one cell: a closed loop of jobs from one client.

Everything that belongs to one configuration, one traffic mix or one
metric sits in a file of its own, found by the name ``BENCHMARK.json``
gives it; there is no registry in code:

- ``configs/<config>.json``: the configuration as it is run (the file
  ``BENCHMARK.json`` names), and ``configs/<config>.py`` beside it, its job
  driver, which provides ``setup(cfg, cell, seed, device) -> state``,
  ``job_inputs(cfg, cell, seed, index)``, ``run_job(state, inputs) ->
  outputs`` (on the host), ``work(cfg, cell)`` (units a job completes),
  ``steps(cfg, cell)`` (driver steps a job takes), ``kernel_batch(cfg,
  cell)``, ``answered(cfg, cell, outputs)``, ``check(cfg, cell, state,
  jobs)`` (the compared numbers, each with its limit, by ``reference``)
  and, for the control, ``control_setup`` and ``control_job``;
- ``cells/<traffic>.json``: the traffic's parameters, and the limits of
  the numbers its comparison reads that the configuration does not state;
- ``metrics/<metric>.py``: one metric's reader, ``read(run) -> float |
  None`` (None: nothing to read, and the metric is left out of the line).

A job is one whole call of the cell's entry point.  Jobs run back to back
from the window's start until ``seconds`` have passed; the job in flight
then finishes and counts.  Every job draws its own inputs from the seed
and its index, so no two inputs repeat.
"""
from __future__ import annotations

import importlib.util
import json
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path

#: the benchmark's folder in a checkout
FOLDER = "port_bench"
#: top-level module names that may not be loaded once the window has closed
FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "qmps_tpu"})


def load_module(path: Path, name: str):
    """A Python file of the benchmark, loaded by its path."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or not path.exists():
        raise FileNotFoundError(f"no module file {path}")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@dataclass
class Spec:
    """One cell as ``BENCHMARK.json`` names it, with its files read."""
    workload: dict
    config: dict  # the configuration file's contents
    traffic: dict  # the traffic file's contents
    end_to_end: list
    per_layer: list
    driver: object  # the configuration's job driver module

    @property
    def name(self) -> str:
        return self.workload["name"]

    def metrics(self, trace: bool) -> list:
        """The metrics a run of this cell reports: end to end with trace 0,
        per layer with trace 1; a metric with a ``workloads`` key only in
        the cells it lists."""
        return [m for m in (self.per_layer if trace else self.end_to_end)
                if self.name in m.get("workloads", [self.name])]


def load_spec(root: Path, workload: str) -> Spec:
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json (has {sorted(cells)})")
    w = cells[workload]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    conf_file = root / conf["file"]
    driver = load_module(conf_file.with_suffix(".py"), f"port_bench_config_{w['config']}")
    traffic = json.loads((root / FOLDER / "cells" / f"{w['traffic']}.json").read_text())
    return Spec(w, json.loads(conf_file.read_text()), traffic, bench["end_to_end"], bench["per_layer"], driver)


@dataclass
class Job:
    start: float
    end: float
    work: float
    inputs: dict
    outputs: dict


@dataclass
class Run:
    """What one run measured; the metric readers read it."""
    spec: Spec
    device: object
    setup_s: float = 0.0
    window_start: float = 0.0
    jobs: list = field(default_factory=list)
    trace: object = None  # yardstick.Trace of the profiled job (trace 1)
    host_s: float = 0.0  # the profiled job's work, timed unprofiled

    @property
    def durations(self) -> list:
        return [j.end - j.start for j in self.jobs]

    def rate(self) -> float:
        """All the work of all jobs over the window, from its start to the
        last job's end."""
        return sum(j.work for j in self.jobs) / (self.jobs[-1].end - self.window_start)


def _sync(device) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def run_cell(root: Path, workload: str, seed: int, seconds: float, trace: bool, device, t_process: float,
             log=print) -> tuple[dict, bool]:
    """One run of a cell on ``device``; returns (the result line's object,
    correct).  ``t_process``: the process's start on the perf_counter."""
    import torch

    spec = load_spec(root, workload)
    drv, cfg, cell = spec.driver, spec.config, spec.traffic
    run = Run(spec, torch.device(device))
    state = drv.setup(cfg, cell, seed, run.device)
    _sync(run.device)

    run.window_start = time.perf_counter()
    run.setup_s = run.window_start - t_process
    index = 0
    while True:
        inputs = drv.job_inputs(cfg, cell, seed, index)
        t0 = time.perf_counter()
        outputs = drv.run_job(state, inputs)  # ends with its results on the host
        t1 = time.perf_counter()
        run.jobs.append(Job(t0, t1, drv.work(cfg, cell), inputs, outputs))
        index += 1
        if t1 - run.window_start >= seconds:
            break
    d = sorted(run.durations)
    log(f"window: {len(d)} jobs in {run.jobs[-1].end - run.window_start:.3f} s; job seconds: "
        f"min {d[0]:.4f}, quartiles {d[len(d) // 4]:.4f} {d[len(d) // 2]:.4f} {d[3 * len(d) // 4]:.4f}, "
        f"max {d[-1]:.4f}; samples {len(d)}", file=sys.stderr)

    if trace:
        _profile(run, drv, state, log)
    on_card = run.device.type == "cuda"
    device_info = {"platform": "gpu" if on_card else "cpu",
                   "kind": torch.cuda.get_device_name(run.device) if on_card else "cpu",
                   "count": 1,
                   "memory_peak_bytes": torch.cuda.max_memory_allocated(run.device) if on_card else 0,
                   "power_limit_w": _power_limit(run.device) if on_card else None}
    if trace:
        device_info.update(busy_s=run.trace.busy_s, window_s=run.trace.window_s)

    metrics = {}
    for m in spec.metrics(trace):
        reader = load_module(root / FOLDER / "metrics" / f"{m['name']}.py", f"port_bench_metric_{m['name']}")
        value = reader.read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    checks = drv.check(cfg, cell, state, run.jobs)
    correct = all(c["ok"] for c in checks.values())
    failed = sum(1 for j in run.jobs if not drv.answered(cfg, cell, j.outputs))
    result = {"correct": correct, "attempted": len(run.jobs), "failed": failed, "metrics": metrics,
              "device": device_info}
    if trace:
        result["breakdown"] = {"device_ops": run.trace.top_device_ops(), "idle_gaps": run.trace.top_idle_gaps()}
    result["checks"] = {k: {"value": c["value"], "limit": c["limit"]} for k, c in checks.items()}
    loaded = sorted({m.split(".")[0] for m in list(sys.modules)} & FORBIDDEN)
    if loaded:
        raise RuntimeError(f"modules loaded that the port may not use: {loaded}")
    return result, correct


def _profile(run: Run, drv, state, log) -> None:
    """Trace one job (the window's first inputs again): its work timed
    unprofiled first, then profiled."""
    from torch.profiler import ProfilerActivity, profile

    from . import yardstick

    inputs = run.jobs[0].inputs
    _sync(run.device)
    t0 = time.perf_counter()
    drv.run_job(state, inputs)
    run.host_s = time.perf_counter() - t0
    activities = [ProfilerActivity.CPU]
    if run.device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        drv.run_job(state, inputs)
        _sync(run.device)
        window_s = time.perf_counter() - t0
    run.trace = yardstick.Trace(yardstick.profile_events(prof), window_s)
    log(f"trace: {run.trace.launches} launch calls, {len(run.trace.device_ops)} device operations, "
        f"busy {run.trace.busy_s:.4f} s of {window_s:.4f} s profiled, {run.host_s:.4f} s unprofiled",
        file=sys.stderr)


def _power_limit(device) -> float | None:
    """The card's power limit in W, as nvidia-smi reads it (the published
    peaks assume 700 W); None where it cannot be read."""
    import subprocess

    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader,nounits",
                              "-i", str(device.index or 0)], capture_output=True, text=True, timeout=30)
        return float(out.stdout.strip())
    except (OSError, ValueError, subprocess.TimeoutExpired):
        return None


def check_entry(value: float, limit: float) -> dict:
    """One compared number: ok when value <= limit; a NaN is never ok."""
    return {"value": float(value), "limit": float(limit), "ok": bool(value <= limit)}
