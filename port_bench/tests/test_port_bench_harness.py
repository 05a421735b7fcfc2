"""CPU tests of the port's benchmark: the job drivers at toy sizes, the
reference against known values, the comparison against broken program
paths and the control, the refusal without a card, the discovery of new
cells, configurations and metrics by their files, and the absence of JAX.

    python -m pytest port_bench/tests -q
"""
from __future__ import annotations

import copy
import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from port_bench import reference as ref
from port_bench import yardstick
from port_bench.harness import FORBIDDEN, run_cell

REPO = Path(__file__).resolve().parents[2]
#: toy cells: (configuration, traffic), the limits as the real cells'
TINY = {
    "tiny_sweep": ("tfim_sweep_d2", {"points": 6}, "sweep_d2_g1024"),
    "tiny_quench": ("tiny_quench_d2", {"trajectories": 3}, "quench_d2_g64"),
}


#: the quench's metrics, whose readers port_bench/metrics holds: the
#: entries a cell of tfim_quench_d2 adds to BENCHMARK.json
QUENCH_METRICS = [
    {"name": "traj_steps_per_s", "unit": "traj-steps/s", "better": "higher", "bound": 0.25, "source": "host_clock",
     "workloads": ["quench_d2_g64"]},
    {"name": "host_launch_calls.quench_inner_step", "unit": "calls/step", "better": "lower",
     "source": "device_trace", "layer": "quench driver", "moves": "traj_steps_per_s", "workloads": ["quench_d2_g64"]},
    {"name": "roofline_pct.tdvp_kernels", "unit": "%", "better": "higher", "source": "device_trace",
     "layer": "CUDA kernels: csrc", "moves": "traj_steps_per_s", "workloads": ["quench_d2_g64"]},
    {"name": "device_idle_pct.quench", "unit": "%", "better": "lower", "source": "device_trace",
     "layer": "device: H100", "moves": "traj_steps_per_s", "workloads": ["quench_d2_g64"]},
]


def _copy(tmp: Path) -> Path:
    """A checkout's benchmark in ``tmp``, with the toy cells added: the
    quench's on a configuration with two starts of its ground state."""
    shutil.copy(REPO / "BENCHMARK.json", tmp)
    shutil.copytree(REPO / "port_bench", tmp / "port_bench", ignore=shutil.ignore_patterns("__pycache__", "tests"))
    configs = tmp / "port_bench" / "configs"
    quench = json.loads((configs / "tfim_quench_d2.json").read_text())
    quench.update(gs_starts=2)
    (configs / "tiny_quench_d2.json").write_text(json.dumps(quench))
    shutil.copy(configs / "tfim_quench_d2.py", configs / "tiny_quench_d2.py")
    bench = json.loads((tmp / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "tiny_quench_d2", "source": "toy", "file": "port_bench/configs/tiny_quench_d2.json",
                             "reduced": [], "why": "toy"})
    quench_metrics = copy.deepcopy(QUENCH_METRICS)
    bench["end_to_end"] += quench_metrics[:1]
    bench["per_layer"] += quench_metrics[1:]
    for name, (config, traffic, like) in TINY.items():
        traffic["limits"] = json.loads((tmp / "port_bench" / "cells" / f"{like}.json").read_text())["limits"]
        bench["workloads"].append({"name": name, "config": config, "traffic": name, "chips": 1, "why": "toy"})
        (tmp / "port_bench" / "cells" / f"{name}.json").write_text(json.dumps(traffic))
        for m in bench["end_to_end"] + bench["per_layer"]:
            if like in m.get("workloads", []):
                m["workloads"].append(name)
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench))
    return tmp


@pytest.fixture(scope="module")
def checkout(tmp_path_factory):
    return _copy(tmp_path_factory.mktemp("checkout"))


def _run(root, workload, trace=False, seed=2 ** 31 + 5):
    return run_cell(root, workload, seed, 0.0, trace, "cpu", time.perf_counter(), log=lambda *a, **k: None)


# ---------------------------------------------------------------------------
# the reference
# ---------------------------------------------------------------------------


def test_exact_energy_known_values():
    assert ref.tfim_energy_exact(1.0) == pytest.approx(-4 / np.pi, abs=1e-12)
    assert ref.tfim_energy_exact(0.0) == pytest.approx(-1.0, abs=1e-12)
    # deep in the paramagnet the energy tends to -g - 1/(4g)
    assert ref.tfim_energy_exact(50.0) == pytest.approx(-50.0 - 1 / 200, abs=1e-5)


def test_loschmidt_rate_known_values():
    t = np.linspace(0, 2, 9)
    assert np.all(ref.loschmidt_rate_exact(t, 0.7, 0.7) == 0)
    assert ref.loschmidt_rate_exact(0.0, 1.5, 0.2) == 0
    lam = ref.loschmidt_rate_exact(t, 1.5, 0.2)
    assert np.all(lam[1:] > 0)
    # short times: lambda(t) = t^2 (the variance density of H1 in the ground
    # state of H0), so lambda(t) / t^2 settles as t -> 0
    small = ref.loschmidt_rate_exact(np.array([1e-3, 2e-3]), 1.5, 0.2) / np.array([1e-3, 2e-3]) ** 2
    assert small[0] == pytest.approx(small[1], rel=1e-5)


def test_mps_energy_of_product_states():
    up = np.zeros((1, 2, 2, 2), complex)
    up[0, 0] = np.eye(2)
    plus = np.ones((1, 2, 2, 2), complex) * 0 + np.eye(2)[None, None] / np.sqrt(2)
    assert ref.mps_energy_f64(up, [0.7])[0] == pytest.approx(-1.0, abs=1e-12)
    assert ref.mps_energy_f64(plus, [0.7])[0] == pytest.approx(0.7, abs=1e-12)


def test_mps_energy_is_gauge_free_and_variational():
    rng = np.random.default_rng(0)
    p = rng.normal(size=(6, 15))
    A = ref.full15_tensor_f64(p)
    g = np.linspace(0.2, 1.8, 6)
    e = ref.mps_energy_f64(A, g)
    X = rng.normal(size=(6, 2, 2)) + 1j * rng.normal(size=(6, 2, 2))
    A2 = 2.5 * np.einsum("bij,bsjk,bkl->bsil", X, A, np.linalg.inv(X))
    np.testing.assert_allclose(ref.mps_energy_f64(A2, g), e, atol=1e-12)
    assert np.all(e >= ref.tfim_energy_exact(g) - 1e-12)


def test_tf32_round_keeps_ten_mantissa_bits():
    x = torch.tensor([1 + 2 ** -10, 1 + 2 ** -11, 1 + 2 ** -12, -(1 + 2 ** -11)], dtype=torch.float32)
    np.testing.assert_array_equal(ref.tf32_round(x).numpy(), [1 + 2 ** -10, 1 + 2 ** -10, 1, -(1 + 2 ** -10)])


def test_implicit_gradient_matches_finite_differences():
    torch.manual_seed(0)
    p = torch.randn(2, 15, dtype=torch.float64, requires_grad=True)
    h = torch.as_tensor(ref.tfim_two_site(np.array([1.5, 0.4]))).to(torch.complex128)

    def energy(q):
        return ref.energy_left_canonical(ref.circuit_tensor(ref.full15_unitary(q, "f64")), h, 48, "f64").sum()

    (g,) = torch.autograd.grad(energy(p), p)
    d = 1e-6
    fd = [(energy(p + d * e) - energy(p - d * e)).item() / (2 * d)
          for e in torch.eye(30, dtype=torch.float64).reshape(30, 2, 15)]
    np.testing.assert_allclose(g.reshape(-1).numpy(), fd, atol=1e-7)


# ---------------------------------------------------------------------------
# the yardstick
# ---------------------------------------------------------------------------


def test_trace_busy_gaps_and_launches():
    ms = 1_000_000
    events = [
        (False, 1, "aten::mm", 0, 10 * ms), (False, 1, "cudaLaunchKernel", 1 * ms, 2 * ms),
        (False, 1, "cudaGraphLaunch", 3 * ms, 4 * ms), (False, 2, "aten::add", 9 * ms, 20 * ms),
        (True, 7, "energy_fwd_quad_kernel", 2 * ms, 5 * ms), (True, 7, "energy_bwd_quad_kernel", 4 * ms, 6 * ms),
        (True, 7, "gemm", 15 * ms, 16 * ms),
    ]
    tr = yardstick.Trace(events, 0.02)
    assert tr.launches == 2
    assert tr.busy_s == pytest.approx(0.005)
    assert tr.top_idle_gaps() == [["aten::add", pytest.approx(0.009)]]
    assert yardstick.idle_pct(tr.busy_s, 0.02) == pytest.approx(75.0)
    assert yardstick.idle_pct(0.0, 0.02) is None
    # K2's and K3's least time at 4,096 elements over their 5 ms
    want = (yardstick.bound_s(28180 * 4096, 236 * 4096) + yardstick.bound_s(23748 * 4096, 428 * 4096)) / 0.005
    kernels = {"energy_fwd": (28180, 236), "energy_bwd": (23748, 428)}
    assert yardstick.kernel_roofline_pct(tr, kernels, 4096) == pytest.approx(100 * want)
    assert yardstick.kernel_roofline_pct(tr, {"tdvp_fwd": (1, 1)}, 64) is None


def test_metric_files_hold_the_frozen_work_counts():
    from port_bench.harness import load_module

    for metric, kernels in (("roofline_pct.energy_kernels", ("K2", "K3")),
                            ("roofline_pct.tdvp_kernels", ("K4", "K5"))):
        held = load_module(REPO / "port_bench" / "metrics" / f"{metric}.py", metric).KERNELS
        assert list(held.values()) == [yardstick.objective_work(k) for k in kernels]
    assert yardstick.objective_work("K2") == (28180, 236) and yardstick.objective_work("K5") == (4604, 588)


# ---------------------------------------------------------------------------
# the harness on the CPU
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("workload", sorted(TINY))
def test_job_driver_at_toy_size(checkout, workload):
    result, correct = _run(checkout, workload)
    assert correct, result["checks"]
    assert result["attempted"] == 1 and result["failed"] == 0
    assert list(result)[-1] == "checks"
    assert "setup_s" in result["metrics"] and len(result["metrics"]) == 2 + (workload == "tiny_sweep")


def test_traced_run_on_the_cpu_leaves_device_metrics_out(checkout):
    result, correct = _run(checkout, "tiny_sweep", trace=True)
    assert correct
    assert result["metrics"] == {}  # no device: every per-layer reader finds nothing
    assert result["device"]["busy_s"] == 0 and result["device"]["window_s"] > 0


def _sweep_fault(monkeypatch, kind):
    from qmps_torch.parallel import sweep

    programs = sweep._fused_sweep_programs

    def broken(*a):
        init, advance, finish = programs(*a)
        if kind == "state_unchanged":
            return init, (lambda V, M, hs, length: (V, M)), finish

        def finish_broken(V, hs):
            e, A = finish(V, hs)
            if kind == "half_left_out":  # the second half never computed: the first half's answers
                h = e.shape[0] // 2
                e, A = e.clone(), A.clone()
                e[h:2 * h], A[h:2 * h] = e[:h], A[:h]
            else:  # an answer altered where it is produced
                e = e.clone()
                e[1] += 1e-3
            return e, A
        return init, advance, finish_broken

    monkeypatch.setattr(sweep, "_fused_sweep_programs", broken)


def _quench_fault(monkeypatch, kind):
    from qmps_torch.algorithms import evolve

    step = evolve._warm_started_minimize
    if kind == "state_unchanged":
        monkeypatch.setattr(evolve, "_warm_started_minimize", lambda loss, p, n, lr: p)
    elif kind == "half_left_out":  # the second half's trajectories never advanced
        def half(loss, p, n, lr):
            q = step(loss, p, n, lr)
            q[p.shape[0] // 2:] = p[p.shape[0] // 2:]
            return q
        monkeypatch.setattr(evolve, "_warm_started_minimize", half)
    else:
        fixed_point = evolve.right_fixed_point

        def altered(A, B):
            lam, r = fixed_point(A, B)
            return lam * torch.where(torch.arange(lam.shape[0]) == 0, 0.99, 1.0).to(lam.dtype), r
        monkeypatch.setattr(evolve, "right_fixed_point", altered)


@pytest.mark.parametrize("kind", ["state_unchanged", "half_left_out", "answer_altered"])
@pytest.mark.parametrize("workload", sorted(TINY))
def test_a_broken_timed_path_reads_not_correct(checkout, monkeypatch, workload, kind):
    (_sweep_fault if workload == "tiny_sweep" else _quench_fault)(monkeypatch, kind)
    result, correct = _run(checkout, workload)
    assert not correct, result["checks"]


def test_an_answer_not_returned_reads_not_correct(checkout, monkeypatch):
    import qmps_torch.parallel as parallel

    fused = parallel.sweep_ground_states_fused

    def nan_energy(*a, **k):
        e, A = fused(*a, **k)
        e = e.clone()
        e[0] = float("nan")
        return e, A

    monkeypatch.setattr(parallel, "sweep_ground_states_fused", nan_energy)
    result, correct = _run(checkout, "tiny_sweep")
    assert not correct and result["failed"] == 1
    assert result["checks"]["answers_missing"]["value"] == 6


@pytest.mark.parametrize("workload", sorted(TINY))
def test_control_reads_not_correct_and_the_plain_float32_reads_correct(checkout, workload):
    from port_bench.control import readings

    tf32 = readings(checkout, workload, "control", 7, 1, "tf32", torch.device("cpu"))
    f32 = readings(checkout, workload, "control", 7, 1, "f32", torch.device("cpu"))
    assert not tf32["correct"], tf32
    assert f32["correct"], f32


# ---------------------------------------------------------------------------
# the command, discovery by files, no JAX
# ---------------------------------------------------------------------------


def test_command_exits_nonzero_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    p = subprocess.run([sys.executable, "-m", "port_bench.run", "--workload", "sweep_d2_g1024", "--seed", "3",
                        "--seconds", "1", "--trace", "0"], cwd=REPO, capture_output=True, text=True, timeout=300)
    assert p.returncode != 0
    assert p.stdout.strip() == ""


def test_command_exits_nonzero_with_the_benchmark_alone(tmp_path):
    shutil.copy(REPO / "BENCHMARK.json", tmp_path)
    shutil.copytree(REPO / "port_bench", tmp_path / "port_bench", ignore=shutil.ignore_patterns("__pycache__"))
    p = subprocess.run([sys.executable, "-m", "port_bench.run", "--workload", "sweep_d2_g1024", "--seed", "3",
                        "--seconds", "1", "--trace", "0"], cwd=tmp_path, capture_output=True, text=True,
                       timeout=300)
    assert p.returncode != 0
    assert p.stdout.strip() == ""


def test_new_cell_config_and_metric_are_found_by_their_files(tmp_path):
    root = _copy(tmp_path)
    bench_dir = root / "port_bench"
    for suffix in (".json", ".py"):
        shutil.copy(bench_dir / "configs" / f"tfim_sweep_d2{suffix}", bench_dir / "configs" / f"new_config{suffix}")
    (bench_dir / "cells" / "new_cell.json").write_text((bench_dir / "cells" / "tiny_sweep.json").read_text())
    (bench_dir / "metrics" / "jobs_done.py").write_text("def read(run):\n    return float(len(run.jobs))\n")
    before = {p: p.read_bytes() for p in bench_dir.rglob("*") if p.is_file() and "new_" not in p.name
              and p.name != "jobs_done.py"}
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "new_config", "source": "toy", "file": "port_bench/configs/new_config.json",
                             "reduced": [], "why": "toy"})
    bench["workloads"].append({"name": "new_cell", "config": "new_config", "traffic": "new_cell", "chips": 1,
                               "why": "toy"})
    bench["end_to_end"].append({"name": "jobs_done", "unit": "jobs", "better": "higher", "bound": 0.25,
                                "source": "host_clock", "workloads": ["new_cell"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    result, correct = _run(root, "new_cell")
    assert correct
    assert result["metrics"]["jobs_done"]["value"] == 1.0
    assert "setup_s" in result["metrics"]
    assert all(p.read_bytes() == b for p, b in before.items())


def test_a_loaded_jax_module_refuses_the_result(checkout, monkeypatch):
    monkeypatch.setitem(sys.modules, "jax.numpy", sys.modules["json"])
    with pytest.raises(RuntimeError, match="jax"):
        _run(checkout, "tiny_sweep")


def test_no_jax_after_a_toy_job(checkout):
    code = (
        "import sys, time; from pathlib import Path; from port_bench.harness import run_cell; "
        f"run_cell(Path({str(checkout)!r}), 'tiny_sweep', 1, 0.0, False, 'cpu', time.perf_counter(), "
        "log=lambda *a, **k: None); "
        "print(sorted({m.split('.')[0] for m in sys.modules}))"
    )
    p = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-2000:]
    loaded = set(json.loads(p.stdout.strip().splitlines()[-1].replace("'", '"')))
    assert "qmps_torch" in loaded
    assert not loaded & FORBIDDEN
