"""The benchmark's large-D configuration on the CPU: the plain reference of
the Stiefel sweep (``port_bench/reference_stiefel.py``) against the
program and against dense ``eig``, its job driver at a toy cell with
planted faults, the work count behind ``roofline_pct.stiefel_job``, the
reader of ``span_replay_pct.stiefel_step`` on synthetic spans, and a
whole run of the toy cell through the harness in a process without JAX.
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

from port_bench import reference as ref
from port_bench import reference_stiefel as refs
from port_bench import stiefel_work
from port_bench.harness import load_module

REPO = Path(__file__).resolve().parents[1]
DRIVER = load_module(REPO / "port_bench" / "configs" / "tfim_stiefel_d16.py", "tfim_stiefel_d16_driver")
CONFIG = json.loads((REPO / "port_bench" / "configs" / "tfim_stiefel_d16.json").read_text())
CELL = json.loads((REPO / "port_bench" / "cells" / "stiefel_d16_g1024.json").read_text())
#: the toy configuration: the real one at D = 4, 150 steps and D = 4's 24
#: environment iterations, so a sweep of 6 points takes ~2 s on one core
TINY_CONFIG = dict(CONFIG, name="tiny_stiefel", D=4, steps=150, recycle_iters=24)


def _random_tensors(n, D, seed):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((n, 2, D, D)) + 1j * rng.standard_normal((n, 2, D, D))


def _energy_by_eig(A, g):
    """The energy per site from dense ``eig`` fixed points, as
    ``reference.mps_energy_f64`` reads it, at any D."""
    out = []
    for a, h in zip(A, ref.tfim_two_site(g)):
        D = a.shape[-1]
        T = np.einsum("sik,sjl->ijkl", a, a.conj()).reshape(D * D, D * D)
        w, v = np.linalg.eig(T)
        r = v[:, np.argmax(np.abs(w))].reshape(D, D)
        w_l, v_l = np.linalg.eig(T.T)
        l = v_l[:, np.argmax(np.abs(w_l))].reshape(D, D)
        lam = w[np.argmax(np.abs(w))]
        AA = np.einsum("sik,tkj->stij", a, a).reshape(4, D, D)
        val = sum(h[t, s] * np.einsum("ji,jk,kl,il->", l, AA[s], r, AA[t].conj()) for s in range(4) for t in range(4))
        out.append((val / (lam ** 2 * np.einsum("ij,ij->", l, r))).real)
    return np.array(out)


# ---------------------------------------------------------------------------
# the float64 readout of any D
# ---------------------------------------------------------------------------


def test_general_readout_equals_the_d2_readout():
    A = np.concatenate([_random_tensors(5, 2, 0), ref.full15_tensor_f64(np.random.default_rng(1).normal(size=(5, 15)))])
    g = np.linspace(0.1, 2.0, 10)
    np.testing.assert_allclose(refs.mps_energy_f64_general(A, g), ref.mps_energy_f64(A, g), rtol=0, atol=1e-12)


def test_general_readout_equals_dense_eig_at_d4():
    A = _random_tensors(6, 4, 2)
    g = np.linspace(0.3, 1.7, 6)
    np.testing.assert_allclose(refs.mps_energy_f64_general(A, g), _energy_by_eig(A, g), rtol=0, atol=1e-12)


@pytest.mark.parametrize("D", [2, 4, 8])
def test_general_readout_is_gauge_invariant_and_variational(D):
    """A random gauge X A X^-1 and a scale move nothing (1e-12); a random
    state lies above the exact energy.  X is a random unitary times a
    diagonal in [1, 2]: the squarings' rounding grows with the condition
    number of X (x) conj(X), here at most 4."""
    rng = np.random.default_rng(D)
    A = _random_tensors(4, D, 3 + D)
    g = np.linspace(0.2, 1.8, 4)
    Q = np.linalg.qr(rng.standard_normal((4, D, D)) + 1j * rng.standard_normal((4, D, D)))[0]
    X = Q * rng.uniform(1.0, 2.0, (4, 1, D))
    A2 = 2.5 * np.einsum("bij,bsjk,bkl->bsil", X, A, np.linalg.inv(X))
    e = refs.mps_energy_f64_general(A, g)
    np.testing.assert_allclose(refs.mps_energy_f64_general(A2, g), e, rtol=0, atol=1e-12)
    assert np.all(e >= ref.tfim_energy_exact(g))


def test_general_readout_of_product_states():
    up = np.zeros((1, 2, 3, 3), complex)
    up[0, 0] = np.eye(3) / np.sqrt(3)
    plus = np.stack([np.eye(3), np.eye(3)])[None] / np.sqrt(6)
    assert refs.mps_energy_f64_general(up, [0.7])[0] == pytest.approx(-1.0, abs=1e-12)
    assert refs.mps_energy_f64_general(plus, [0.7])[0] == pytest.approx(0.7, abs=1e-12)


# ---------------------------------------------------------------------------
# the plain sweep against the program
# ---------------------------------------------------------------------------


def test_start_normals_are_the_entry_points():
    """The driver draws the normals the entry point draws from the same
    generator, every restart slot."""
    from qmps_torch.parallel import sweep

    seed = int(torch.randint(0, 2 ** 62, (1,), generator=torch.Generator().manual_seed(11)))
    want = sweep._nested_restart_normals(seed, 2, (3, 8, 4))
    got = DRIVER.start_normals(11, 3, 2, 4)
    for w, x in zip(want, got):
        assert torch.equal(w.reshape(6, 8, 4), x)


def test_program_matches_the_plain_sweep_at_f64():
    """``sweep_ground_states_stiefel`` against ``stiefel_sweep_plain`` at
    complex128 from the same normals, D = 4, 8 points, 20 steps: the
    energies and the tensors agree to 1e-9.  They differ only in the
    polar factor, the program's 10-iteration Newton-Schulz with its
    relative jitter of 1e-12 against the plain exact one by ``eigh``: a
    departure near 1e-12 a retraction, which 20 heavy-ball steps carry to
    3e-12 in the energies and 2e-11 in the tensors (measured)."""
    from qmps_torch.parallel import sweep_ground_states_stiefel

    D, n, steps = 4, 8, 20
    g = np.linspace(0.2, 1.9, n)
    es, As, _ = sweep_ground_states_stiefel(g, D=D, steps=steps, generator=torch.Generator().manual_seed(5),
                                            recycle_iters=24, final_iters=200, device="cpu")
    xre, xim = DRIVER.start_normals(5, n, 1, D)
    es_p, As_p = refs.stiefel_sweep_plain(g, xre, xim, D, steps, 0.08, 0.9, 1, 24, 200, "f64", "cpu")
    assert es.dtype == torch.float64
    np.testing.assert_allclose(es.numpy(), es_p, rtol=0, atol=1e-9)
    np.testing.assert_allclose(As.numpy(), As_p, rtol=0, atol=1e-9)


def test_plain_sweep_at_f32_and_tf32_runs_in_complex64():
    g = np.array([0.5, 1.5])
    xre, xim = DRIVER.start_normals(3, 2, 2, 4)
    e64, _ = refs.stiefel_sweep_plain(g, xre, xim, 4, 30, 0.08, 0.9, 2, 24, 200, "f64", "cpu")
    for prec, tol in (("f32", 1e-4), ("tf32", 3e-2)):
        e, A = refs.stiefel_sweep_plain(g, xre, xim, 4, 30, 0.08, 0.9, 2, 24, 200, prec, "cpu")
        assert A.dtype == np.complex64 and A.shape == (2, 2, 4, 4)
        np.testing.assert_allclose(e, e64, atol=tol)


def test_reference_imports_neither_jax_nor_the_program():
    tree = ast.parse((REPO / "port_bench" / "reference_stiefel.py").read_text())
    names = {a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names}
    names |= {n.module or "" for n in ast.walk(tree) if isinstance(n, ast.ImportFrom)}
    assert not {m.split(".")[0] for m in names} & {"jax", "jaxlib", "flax", "qmps_tpu", "qmps_torch"}
    code = "import sys, port_bench.reference_stiefel; print(sorted({m.split('.')[0] for m in sys.modules}))"
    p = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr[-2000:]
    assert not set(json.loads(p.stdout.strip().replace("'", '"'))) & {"jax", "jaxlib", "qmps_tpu", "qmps_torch"}


# ---------------------------------------------------------------------------
# the work count
# ---------------------------------------------------------------------------


def test_work_count_cross_checks_the_jax_packages_audit():
    """The step's complex multiply-adds at D = 16 and 96 environment
    iterations, counted as XLA's cost model counts a dot (2 flops a
    multiply-add), come within 10% of bench.py's audited 11,107,065 flops
    a point-step (its elementwise work not counted here); the real flops
    are 8 a multiply-add.  The readout's power of the 256 x 256 transfer
    matrix is chip_smoke.py's count for K8 (``matpow_flops``) with each
    complex product as four real ones (8 N^3) where K8's audit counts
    three (``csquare_flops``), at the squarings the program and the
    reference take; it is about 30% of a job's work."""
    import inspect

    from qmps_torch.parallel import sweep

    cmacs = stiefel_work.step_cmacs(16, 96)
    assert abs(2 * cmacs / 11_107_065 - 1) < 0.10
    assert 8 * cmacs < stiefel_work.step_flops(16, 96) < 8.2 * cmacs
    squarings = stiefel_work.READOUT_SQUARINGS
    assert squarings == sweep.READOUT_SQUARINGS == inspect.signature(refs.dominant_projection).parameters[
        "squarings"].default
    chip_smoke = load_module(REPO / "chip_smoke.py", "chip_smoke_work_count")
    N = 16 * 16
    assert stiefel_work.power_flops(16) == (chip_smoke.matpow_flops(N, squarings)
                                            + squarings * (8 * N ** 3 - chip_smoke.csquare_flops(N)))
    readout = stiefel_work.readout_flops(16, 200)
    flops, nbytes = stiefel_work.job_work(1024, 1, 16, 300, 96, 200)
    assert flops == 1024 * (300 * stiefel_work.step_flops(16, 96) + readout)
    assert 0.25 < 1024 * readout / flops < 0.35
    assert nbytes < 1e-6 * flops  # bound by the operations


@pytest.mark.parametrize("steps,replays,want", [(300, 298, 99.33), (300, 0, None), (0, 0, None)])
def test_replay_share_reader_on_synthetic_spans(steps, replays, want):
    """``span_replay_pct.stiefel_step`` on a synthetic spans-on job: 100 x
    the ``stiefel.replay`` spans over the ``stiefel.step`` spans (298 of
    300: 99.33); None with no replay (a program that never captures the
    step, as before the graph) or no step; None without spans at all."""
    from port_bench.harness import Run
    from qmps_torch.utils.profiling import Span

    reader = load_module(REPO / "port_bench" / "metrics" / "span_replay_pct.stiefel_step.py", "replay_pct_reader")
    sp = [Span(i, None, i, "stiefel.step", i, i + 1, 1) for i in range(steps)]
    sp += [Span(steps + i, i, i, "stiefel.replay", i, i + 1, 1) for i in range(replays)]
    run = Run(None, torch.device("cuda"))
    run.spans, run.traced_spans, run.span_trace = sp, sp, None
    got = reader.read(run)
    assert got == (None if want is None else pytest.approx(want, abs=5e-3))
    run.spans = None
    assert reader.read(run) is None


# ---------------------------------------------------------------------------
# the job driver at a toy cell
# ---------------------------------------------------------------------------


def _checkout(tmp: Path) -> Path:
    """A checkout's benchmark in ``tmp`` with the toy cell ``tiny_stiefel``
    (6 points) on the toy configuration, listed where the real cell is."""
    shutil.copy(REPO / "BENCHMARK.json", tmp)
    shutil.copytree(REPO / "port_bench", tmp / "port_bench", ignore=shutil.ignore_patterns("__pycache__", "tests"))
    configs = tmp / "port_bench" / "configs"
    (configs / "tiny_stiefel.json").write_text(json.dumps(TINY_CONFIG))
    shutil.copy(configs / "tfim_stiefel_d16.py", configs / "tiny_stiefel.py")
    # the toy's descent at D = 4 is held to config 4's stated bar: the
    # cell's gap_median limit is read off D = 16 states
    limits = dict(CELL["limits"], gap_median=CONFIG["accuracy"]["gap_median"])
    (tmp / "port_bench" / "cells" / "tiny_stiefel.json").write_text(json.dumps(dict(CELL, points=6, limits=limits)))
    bench = json.loads((tmp / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "tiny_stiefel", "source": "toy", "file": "port_bench/configs/tiny_stiefel.json",
                             "reduced": ["D", "steps", "recycle_iters"], "why": "toy"})
    bench["workloads"].append({"name": "tiny_stiefel", "config": "tiny_stiefel", "traffic": "tiny_stiefel",
                               "chips": 1, "why": "toy"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "stiefel_d16_g1024" in m.get("workloads", []):
            m["workloads"].append("tiny_stiefel")
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench))
    return tmp


@pytest.fixture(scope="module")
def checkout(tmp_path_factory):
    return _checkout(tmp_path_factory.mktemp("checkout"))


def _plant(monkeypatch, kind):
    from qmps_torch.parallel import sweep

    programs = sweep._stiefel_sweep_programs

    def broken(*a):
        init, advance, finish = programs(*a)
        if kind == "state_unchanged":
            return init, (lambda V, M, r, hs, length: (V, M, r)), finish

        def finish_broken(V, r, hs):
            e, A, rb = finish(V, r, hs)
            e, A = e.clone(), A.clone()
            if kind == "half_left_out":  # the second half never computed: the first half's answers
                h = e.shape[0] // 2
                e[h:2 * h], A[h:2 * h] = e[:h], A[:h]
            else:  # an answer altered where it is produced, by three times the limit
                e[1] += 3 * CELL["limits"]["energy_err_max"]
            return e, A, rb
        return init, advance, finish_broken

    if kind != "sound":
        monkeypatch.setattr(sweep, "_stiefel_sweep_programs", broken)


@pytest.mark.parametrize("kind", ["sound", "state_unchanged", "half_left_out", "answer_altered"])
def test_a_broken_timed_path_reads_not_correct(checkout, monkeypatch, kind):
    """The toy cell's comparison passes on the program as it is, and each
    planted fault fails at least one of its numbers."""
    from port_bench.control import readings

    _plant(monkeypatch, kind)
    got = readings(checkout, "tiny_stiefel", "program", 2 ** 31 + 9, 1, "tf32", torch.device("cpu"))
    assert got["correct"] == (kind == "sound"), got["checks"]
    assert got["checks"]["answers_missing"] == 0


def test_program_default_control_runs_the_program_at_its_default_tier(checkout, monkeypatch):
    """``--prec program_default`` runs the entry point itself with its first
    (here all) steps under the "default" tier, and reads the same
    numbers."""
    from port_bench.control import readings
    from qmps_torch.parallel import sweep

    tiers, tier = [], sweep._matmul_tier
    monkeypatch.setattr(sweep, "_matmul_tier", lambda precision: tiers.append(precision) or tier(precision))
    got = readings(checkout, "tiny_stiefel", "control", 2 ** 31 + 9, 1, DRIVER.PROGRAM_DEFAULT, torch.device("cpu"))
    assert tiers == ["default"] and got["prec"] == DRIVER.PROGRAM_DEFAULT
    assert list(got["checks"]) == ["energy_err_max", "gap_median", "gap_max", "below_exact", "answers_missing"]


def test_a_run_of_the_toy_cell_in_a_process_without_jax(checkout):
    """The harness runs the toy cell end to end, untraced and traced: the
    untraced line carries ``setup_s`` and ``gs_points_per_s``; on the CPU
    every per-layer reader of the cell finds nothing and the line leaves
    them out; no JAX module is loaded."""
    code = (
        "import json, sys, time; from pathlib import Path; from port_bench.harness import run_cell; "
        "out = [run_cell(Path(sys.argv[1]), 'tiny_stiefel', 2 ** 33 + 1, 0.0, t, 'cpu', time.perf_counter(), "
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
        assert list(result["checks"]) == ["energy_err_max", "gap_median", "gap_max", "below_exact",
                                          "answers_missing"]
    assert set(untraced["metrics"]) == {"setup_s", "gs_points_per_s"}
    assert traced["metrics"] == {} and traced["device"]["busy_s"] == 0
    assert not set(json.loads(lines[-1])) & {"jax", "jaxlib", "flax", "qmps_tpu"}
