"""The benchmark's brick-wall configuration on the CPU: the plain reference
(``port_bench/reference_brickwork.py``) against the program's wall, its
float64 readout against a sweep's own energies, the plain sweep against
the program's from the same starts, the job driver at a toy cell with
planted faults, ``gap_max`` over the window's first jobs only, the
reference's imports, and a whole run of the toy cell through the harness
in a process without JAX.
"""
from __future__ import annotations

import ast
import json
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from _torch_parity import assert_brick_params_match

from port_bench import reference_brickwork as refb
from port_bench.harness import Job, load_module

REPO = Path(__file__).resolve().parents[1]
DRIVER = load_module(REPO / "port_bench" / "configs" / "tfim_deep_bw_d8.py", "tfim_deep_bw_d8_driver")
CONFIG = json.loads((REPO / "port_bench" / "configs" / "tfim_deep_bw_d8.json").read_text())
CELL = json.loads((REPO / "port_bench" / "cells" / "deep_bw_d8_g1024.json").read_text())
#: the toy configuration: the real one at D = 4 (a depth-4 wall of 4 bricks
#: on 3 qubits), 150 steps and 1 refine pass, so a job of 6 points takes
#: ~5 s on one core
TINY_CONFIG = dict(CONFIG, name="tiny_deep_bw", D=4, n_qubits=3, depth=4, bricks=4, n_params=76, steps=150,
                   refine_passes=1)
#: the toy cell: 6 points, the descent held to config 4's stated bar (the
#: cell's gap_median limit is read off D = 8 states)
TINY_CELL = dict(CELL, points=6, limits=dict(CELL["limits"], gap_median=CONFIG["accuracy"]["gap_median"]))
SEED = 2 ** 31 + 9


def _sweep(g, D, steps, refine_passes, seed, recycle=None):
    from qmps_torch.parallel import sweep_ground_states

    return sweep_ground_states(torch.tensor(g, dtype=torch.float64), D=D, ansatz="deep_bw", steps=steps, lr=0.05,
                               refine_passes=refine_passes, generator=torch.Generator().manual_seed(seed),
                               recycle=recycle, device="cpu")


# ---------------------------------------------------------------------------
# the reference against the program
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("D", [2, 4, 8])
def test_reference_wall_matches_the_program(D):
    """The dense wall and its tensor, from the published gates and layout,
    against ``brick_wall_unitary``'s compiled circuit at complex128: 1e-12
    (measured 3e-16 to 8e-16, the rounding of 8 products of 16 x 16)."""
    from qmps_torch.circuits.brickwork_deep import brick_layout, brick_wall_tensor, brick_wall_unitary, n_brick_params

    n = refb.n_qubits(D)
    assert refb.brick_layout(n, n + 1) == brick_layout(n, n + 1)
    p = torch.randn(5, n_brick_params(n, n + 1), generator=torch.Generator().manual_seed(D), dtype=torch.float64)
    torch.testing.assert_close(refb.wall_unitary(p, n, n + 1, "f64"), brick_wall_unitary(p, n, n + 1), rtol=0,
                               atol=1e-12)
    torch.testing.assert_close(refb.wall_tensor(p, D, "f64"), brick_wall_tensor(p, D, n + 1), rtol=0, atol=1e-12)


def test_reference_reads_a_sweeps_returned_energies():
    """The float64 energy of the parameters a small sweep returns (D = 4, 8
    points, 20 steps, 1 refine pass, complex128) against the sweep's own
    energies: 1e-12.  Both read the same states at complex128, the
    program from its environment projected onto the dominant eigenspace
    and 200 power matvecs, the reference from its dominant projector:
    each exact to rounding (measured 4e-15 to 8e-15)."""
    g = np.linspace(0.2, 1.9, 8)
    es, ps = _sweep(g, 4, 20, 1, 5)
    assert es.dtype == torch.float64
    np.testing.assert_allclose(refb.wall_energy_f64(ps.numpy(), g, 4), es.numpy(), rtol=0, atol=1e-12)


@pytest.mark.parametrize("recycle,steps", [(False, 20), (True, 150)])
def test_plain_sweep_matches_the_program_from_the_same_starts(recycle, steps):
    """``deep_bw_sweep_plain`` at complex128 against ``sweep_ground_states``
    from the same starts, D = 4, 8 points, 1 refine pass.

    recycle off (the program's exact environment every step, the
    reference's method): energies to 1e-12 (measured 5e-15) and the
    parameters as ``assert_brick_params_match`` holds them (measured 4e-14
    off the U2f phase coordinates, 5e-8 on them, which adam moves by
    rounding alone).

    recycle on (the path the cell runs: 24 warm matvecs a step, from the
    identity at the first step, differentiated through): its early
    gradients depart from the exact ones by the power residual, so the
    descents take other paths (parameters O(1) apart), but each reaches the
    same minima: energies to 1e-3 after 150 steps (measured 2.2e-4; 7e-4
    at 100 steps, 6e-3 at 60)."""
    g = np.linspace(0.2, 1.9, 8)
    es, ps = _sweep(g, 4, steps, 1, 5, recycle)
    p0 = DRIVER.start_params(5, 8, 1, ps.shape[1])[:, 0]
    er, pr = refb.deep_bw_sweep_plain(g, p0.numpy(), 4, steps, 0.05, 1, "f64")
    if recycle:
        np.testing.assert_allclose(es.numpy(), er, rtol=0, atol=1e-3)
    else:
        np.testing.assert_allclose(es.numpy(), er, rtol=0, atol=1e-12)
        assert_brick_params_match(ps, pr)


def test_every_read_projects_its_environment(monkeypatch):
    """Each read of an energy, a descent's final read (5 with 2 refine
    passes) and a neighbour evaluation (4), projects its environment onto
    the dominant eigenspace before its matvecs, as the Stiefel readout does
    (``sweep._dominant_environment``); no adam step does.  On the card the
    matvecs alone misread states whose transfer matrix has |lam_2 / lam_1|
    within 1e-5 of 1, which the descent reaches."""
    from qmps_torch.parallel import sweep

    seen, project = [], sweep._dominant_environment

    def spy(V, r, D):
        seen.append((torch.is_grad_enabled(), V.shape[0]))
        return project(V, r, D)

    monkeypatch.setattr(sweep, "_dominant_environment", spy)
    _sweep(np.linspace(0.3, 1.5, 5), 4, 3, 2, 13)
    assert seen == [(False, 5)] * 9


def test_start_params_are_the_entry_points():
    """The driver draws the starts the entry point draws from the same
    generator (read where the entry point hands them to its body)."""
    from qmps_torch.parallel import sweep

    seen = []

    def body(gs, p0s, *a):
        seen.append(p0s)
        return gs, p0s[:, 0]

    mp = pytest.MonkeyPatch()
    mp.setattr(sweep, "_sweep_from_starts", body)
    try:
        _sweep(np.linspace(0.3, 1.5, 5), 8, 1, 0, 13)
    finally:
        mp.undo()
    assert torch.equal(seen[0], DRIVER.start_params(13, 5, 1, CONFIG["n_params"]))


def test_reference_imports_neither_jax_nor_the_program():
    tree = ast.parse((REPO / "port_bench" / "reference_brickwork.py").read_text())
    names = {a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names}
    names |= {n.module or "" for n in ast.walk(tree) if isinstance(n, ast.ImportFrom)}
    assert not {m.split(".")[0] for m in names} & {"jax", "jaxlib", "flax", "qmps_tpu", "qmps_torch"}
    code = "import sys, port_bench.reference_brickwork; print(sorted({m.split('.')[0] for m in sys.modules}))"
    p = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr[-2000:]
    assert not set(json.loads(p.stdout.strip().replace("'", '"'))) & {"jax", "jaxlib", "qmps_tpu", "qmps_torch"}


# ---------------------------------------------------------------------------
# the job driver at a toy cell
# ---------------------------------------------------------------------------


def _checkout(tmp: Path) -> Path:
    """A checkout's benchmark in ``tmp`` with the toy cell ``tiny_deep_bw``
    on the toy configuration, listed where the real cell is."""
    shutil.copy(REPO / "BENCHMARK.json", tmp)
    shutil.copytree(REPO / "port_bench", tmp / "port_bench", ignore=shutil.ignore_patterns("__pycache__", "tests"))
    configs = tmp / "port_bench" / "configs"
    (configs / "tiny_deep_bw.json").write_text(json.dumps(TINY_CONFIG))
    shutil.copy(configs / "tfim_deep_bw_d8.py", configs / "tiny_deep_bw.py")
    (tmp / "port_bench" / "cells" / "tiny_deep_bw.json").write_text(json.dumps(TINY_CELL))
    bench = json.loads((tmp / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "tiny_deep_bw", "source": "toy", "file": "port_bench/configs/tiny_deep_bw.json",
                             "reduced": ["D", "steps", "refine_passes"], "why": "toy"})
    bench["workloads"].append({"name": "tiny_deep_bw", "config": "tiny_deep_bw", "traffic": "tiny_deep_bw",
                               "chips": 1, "why": "toy"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "deep_bw_d8_g1024" in m.get("workloads", []):
            m["workloads"].append("tiny_deep_bw")
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench))
    return tmp


@pytest.fixture(scope="module")
def checkout(tmp_path_factory):
    return _checkout(tmp_path_factory.mktemp("checkout"))


def _plant(monkeypatch, kind):
    from qmps_torch.parallel import sweep

    if kind == "state_unchanged":  # every descent returns its start
        programs = sweep._chart_programs

        def unchanged(*a, **k):
            optimize, evaluate, step_loss = programs(*a, **k)
            return (lambda hs, p0: (evaluate(hs, p0), p0)), evaluate, step_loss

        monkeypatch.setattr(sweep, "_chart_programs", unchanged)
    elif kind != "sound":
        body = sweep._sweep_from_starts

        def broken(*a, **k):
            e, p = body(*a, **k)
            e, p = e.clone(), p.clone()
            if kind == "half_left_out":  # the second half never computed: the first half's answers
                h = e.shape[0] // 2
                e[h:2 * h], p[h:2 * h] = e[:h], p[:h]
            else:  # an answer altered where it is produced, by three times the limit
                e[1] += 3 * CELL["limits"]["energy_err_max"]
            return e, p

        monkeypatch.setattr(sweep, "_sweep_from_starts", broken)


@pytest.mark.parametrize("kind", ["sound", "state_unchanged", "half_left_out", "answer_altered"])
def test_a_broken_timed_path_reads_not_correct(checkout, monkeypatch, kind):
    """The toy cell's comparison passes on the program as it is, and each
    planted fault fails at least one of its numbers."""
    from port_bench.control import readings

    _plant(monkeypatch, kind)
    got = readings(checkout, "tiny_deep_bw", "program", SEED, 1, "tf32", torch.device("cpu"))
    assert got["correct"] == (kind == "sound"), got["checks"]
    assert got["checks"]["answers_missing"] == 0
    assert list(got["checks"]) == ["energy_err_max", "gap_median", "gap_max", "below_exact", "answers_missing"]


def test_gap_max_reads_the_windows_first_two_jobs(checkout):
    """``gap_max`` reads the window's first ``gap_max_jobs`` (2) jobs and no
    others: a third job of random parameters (gaps of order 1) leaves it
    as the first two read it; the same job second fails it."""
    from port_bench.harness import load_spec

    assert CELL["gap_max_jobs"] == 2
    spec = load_spec(checkout, "tiny_deep_bw")
    drv, cfg, cell = spec.driver, spec.config, spec.traffic
    state = drv.setup(cfg, cell, SEED, torch.device("cpu"))
    jobs = []
    for index in range(2):
        inputs = drv.job_inputs(cfg, cell, SEED, index)
        jobs.append(Job(0.0, 1.0, 6, inputs, drv.run_job(state, inputs)))
    bad = Job(0.0, 1.0, 6, jobs[0].inputs, dict(jobs[0].outputs, params=np.random.default_rng(0).normal(
        size=jobs[0].outputs["params"].shape)))
    two = drv.check(cfg, cell, state, jobs)["gap_max"]
    assert two["ok"] and two["value"] > 0
    third = drv.check(cfg, cell, state, jobs + [bad])
    assert third["gap_max"] == two and not third["gap_median"]["ok"]
    second = drv.check(cfg, cell, state, [jobs[0], bad, jobs[1]])["gap_max"]
    assert not second["ok"] and second["value"] > 0.05


@pytest.mark.parametrize("prec", ["f64", "program_tf32"])
def test_controls_read_the_same_numbers(checkout, monkeypatch, prec):
    """The controls run in the program's place from the same job inputs:
    the plain sweep at ``prec`` (sound at f64 on the toy), or the program
    with TF32 allowed in its cuBLAS products, the flags restored after."""
    from port_bench.control import readings

    seen = []
    if prec == DRIVER.PROGRAM_TF32:
        from qmps_torch.parallel import sweep

        body = sweep._sweep_from_starts

        def spy(*a, **k):
            seen.append((torch.backends.cuda.matmul.allow_tf32, torch.get_float32_matmul_precision()))
            return body(*a, **k)

        monkeypatch.setattr(sweep, "_sweep_from_starts", spy)
    got = readings(checkout, "tiny_deep_bw", "control", SEED, 1, prec, torch.device("cpu"))
    assert got["correct"], got["checks"]
    assert list(got["checks"]) == ["energy_err_max", "gap_median", "gap_max", "below_exact", "answers_missing"]
    if prec == DRIVER.PROGRAM_TF32:
        assert seen == [(True, "high")]
        assert (torch.backends.cuda.matmul.allow_tf32, torch.get_float32_matmul_precision()) == (False, "highest")


def test_a_run_of_the_toy_cell_in_a_process_without_jax(checkout):
    """The harness runs the toy cell end to end, untraced and traced: the
    untraced line carries ``setup_s`` and ``gs_points_per_s``; on the CPU
    every per-layer reader of the cell finds nothing and the line leaves
    them out; no JAX module is loaded."""
    code = (
        "import json, sys, time; from pathlib import Path; from port_bench.harness import run_cell; "
        "out = [run_cell(Path(sys.argv[1]), 'tiny_deep_bw', 2 ** 33 + 1, 0.0, t, 'cpu', time.perf_counter(), "
        "log=lambda *a, **k: None)[0] for t in (False, True)]; "
        "print(json.dumps(out)); print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"
    )
    p = subprocess.run([sys.executable, "-c", code, str(checkout)], cwd=REPO, capture_output=True, text=True,
                       timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    lines = p.stdout.strip().splitlines()
    untraced, traced = json.loads(lines[-2])
    for result in (untraced, traced):
        assert result["correct"] and result["attempted"] == 1 and result["failed"] == 0, result
    assert set(untraced["metrics"]) == {"setup_s", "gs_points_per_s"}
    assert traced["metrics"] == {} and traced["device"]["busy_s"] == 0
    assert not set(json.loads(lines[-1])) & {"jax", "jaxlib", "flax", "qmps_tpu"}


def test_the_configuration_is_the_benchmarks():
    """The configuration the cell names, as ``BENCHMARK.json`` lists it:
    the published D = 8 wall (depth n + 1 = 5 on 4 qubits, 8 bricks, 152
    parameters), nothing cut, and the cell on one chip in
    ``gs_points_per_s``'s list."""
    from qmps_torch.circuits.brickwork_deep import brick_layout, n_brick_params

    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    conf = {c["name"]: c for c in bench["configs"]}["tfim_deep_bw_d8"]
    cell = {w["name"]: w for w in bench["workloads"]}["deep_bw_d8_g1024"]
    assert conf["reduced"] == [] == CONFIG["reduced"] and conf["file"] == "port_bench/configs/tfim_deep_bw_d8.json"
    assert cell["config"] == "tfim_deep_bw_d8" and cell["chips"] == 1 and len(cell["why"]) <= 200
    assert "deep_bw_d8_g1024" in {m["name"]: m for m in bench["end_to_end"]}["gs_points_per_s"]["workloads"]
    n, depth = CONFIG["n_qubits"], CONFIG["depth"]
    assert (CONFIG["D"], n, depth) == (8, 4, 5) and len(brick_layout(n, depth)) == CONFIG["bricks"] == 8
    assert n_brick_params(n, depth) == CONFIG["n_params"] == 152
    assert (CONFIG["steps"], CONFIG["lr"], CONFIG["restarts"], CONFIG["refine_passes"]) == (300, 0.05, 1, 2)
    assert CELL["points"] == 1024
