"""CPU tests of the span metrics (``port_bench/spans.py`` and the readers
``metrics/span_*.py``): the launch-in-span, idle-in-span, self-time and
idle-by-innermost-span arithmetic on synthetic spans and trace events;
the spans-on jobs on a toy sweep; a traced toy run on the CPU, which reads
none of them and leaves spans off; a program without spans, which reads
none of them and does not raise.

    python -m pytest port_bench/tests -q
"""
from __future__ import annotations

import time
from pathlib import Path

import pytest
import torch
from test_port_bench_harness import _copy, _run

from port_bench import spans, yardstick
from port_bench.harness import Job, Run, load_module, load_spec
from qmps_torch.utils import profiling
from qmps_torch.utils.profiling import Span

REPO = Path(__file__).resolve().parents[2]
SPAN_METRICS = ["span_ms.sweep_init", "span_ms.sweep_step", "span_us.kernel_call", "span_launches.sweep_init",
                "span_launches.sweep_step", "span_idle_pct.sweep_init", "span_idle_pct.sweep_step"]
MS = 1_000_000


def _reader(name):
    return load_module(REPO / "port_bench" / "metrics" / f"{name}.py", f"port_bench_metric_{name}")


@pytest.fixture(scope="module")
def checkout(tmp_path_factory):
    return _copy(tmp_path_factory.mktemp("checkout"))


def _synthetic_run():
    """A job of 10 ms: init 0-2 ms, two steps 2-5 and 5-8 ms (a forward with
    a kernel wrapper in each, the first's backward on another thread), finish
    8-9 ms; launch calls at 0.5, 1, 1.5 (init), 3, 4, 6 (steps) and 8.5 ms
    (finish); device work at 0-0.2, 1-1.2, 3.5-4.5, 6-6.5 and 9.5-9.6 ms."""
    sp = [
        Span(1, None, 1, "sweep.job", 0, 10 * MS, 1),
        Span(2, 1, 1, "sweep.init", 0, 2 * MS, 1),
        Span(3, 1, 1, "sweep.step", 2 * MS, 5 * MS, 1),
        Span(4, 3, 1, "energy.forward", 2 * MS, 3 * MS, 1),
        Span(5, 4, 1, "kernel.energy_fwd", 2 * MS + MS // 2, 3 * MS, 1),
        Span(6, None, 6, "kernel.energy_bwd", 3 * MS + MS // 2, 4 * MS, 2),  # autograd's thread
        Span(7, 1, 1, "sweep.step", 5 * MS, 8 * MS, 1),
        Span(8, 7, 1, "energy.forward", 5 * MS, 6 * MS, 1),
        Span(9, 8, 1, "kernel.energy_fwd", 5 * MS, 5 * MS + MS // 4, 1),
        Span(10, 1, 1, "sweep.finish", 8 * MS, 9 * MS, 1),
    ]
    launch = [0.5, 1, 1.5, 3, 4, 6, 8.5]
    dev = [(0, 0.2), (1, 1.2), (3.5, 4.5), (6, 6.5), (9.5, 9.6)]
    events = [(False, 1, "cudaLaunchKernel", int(t * MS), int(t * MS) + 1000) for t in launch]
    events += [(False, 1, "aten::mm", 0, 10 * MS)]
    events += [(True, 7, "k", int(a * MS), int(b * MS)) for a, b in dev]
    run = Run(None, torch.device("cuda"))
    run.trace = yardstick.Trace(events, 0.01)
    run.spans, run.traced_spans, run.span_trace = sp, sp, spans.SpanTrace(events)
    return run


def test_span_trace_keeps_launch_starts_and_idle_gaps():
    run = _synthetic_run()
    tr = run.span_trace
    # the same launch calls and idle gaps as yardstick.Trace counts and names
    assert len(tr.launch_starts_ns) == run.trace.launches == 7
    assert sum(b - a for a, b in tr.idle_gaps_ns) / 1e9 == pytest.approx(sum(s for _, s in run.trace.gaps))
    assert tr.launch_starts_ns == [int(t * MS) for t in (0.5, 1, 1.5, 3, 4, 6, 8.5)]
    assert tr.idle_gaps_ns == [(int(a * MS), int(b * MS)) for a, b in
                               ((0.2, 1), (1.2, 3.5), (4.5, 6), (6.5, 9.5))]


def test_span_metrics_on_synthetic_spans_and_events():
    run = _synthetic_run()
    got = {m: _reader(m).read(run) for m in SPAN_METRICS}
    assert got["span_ms.sweep_init"] == pytest.approx(2.0)
    assert got["span_ms.sweep_step"] == pytest.approx(3.0)
    # self times 0.5, 0.5 and 0.25 ms: the kernel spans have no children
    assert got["span_us.kernel_call"] == pytest.approx(500.0)
    assert got["span_launches.sweep_init"] == 3.0
    assert got["span_launches.sweep_step"] == pytest.approx(3 / 2)
    # idle gaps 0.8 + 2.3 + 1.5 + 3.0 = 7.6 ms; init open 0.8 + 0.8, a step 1.5 + 1.5 + 1.5
    assert got["span_idle_pct.sweep_init"] == pytest.approx(100 * 1.6 / 7.6)
    assert got["span_idle_pct.sweep_step"] == pytest.approx(100 * 4.5 / 7.6)


def test_self_time_subtracts_the_children():
    own = spans.self_ns(_synthetic_run().spans)
    assert own[1] == 10 * MS - 2 * MS - 3 * MS - 3 * MS - 1 * MS  # the job less init, two steps and finish
    assert own[3] == 2 * MS and own[4] == MS // 2 and own[6] == MS // 2


def test_idle_by_innermost_span():
    run = _synthetic_run()
    idle = spans.idle_by_innermost(run.span_trace.idle_gaps_ns, run.traced_spans)
    # init and job open at 0: init, opened second, is the inner; the backward's kernel runs on busy time
    want = {"sweep.init": 0.8 + 0.8, "energy.forward": 0.5 + 0.75, "kernel.energy_fwd": 0.5 + 0.25,
            "sweep.step": 0.5 + 0.5 + 1.5, "sweep.finish": 1.0, "sweep.job": 0.5}
    assert idle == {k: pytest.approx(v * 1e-3) for k, v in want.items()}
    assert sum(idle.values()) == pytest.approx(7.6e-3)
    assert spans.idle_by_innermost([(0, 5)], [])[spans.NO_SPAN] == pytest.approx(5e-9)


def test_interval_helpers():
    u = spans.intervals([Span(1, None, 1, "a", 5, 9, 1), Span(2, None, 2, "a", 0, 3, 1),
                         Span(3, None, 3, "a", 2, 4, 2), Span(4, None, 4, "b", 0, 100, 1)], "a")
    assert u == [(0, 4), (5, 9)]
    assert spans.count_inside([0, 1, 4, 4, 5, 6, 10], u) == 6
    assert spans.overlap_ns([(1, 6), (8, 20)], u) == 3 + 1 + 1


def _toy_run(checkout):
    spec = load_spec(checkout, "tiny_sweep")
    run = Run(spec, torch.device("cpu"))
    inputs = spec.driver.job_inputs(spec.config, spec.traffic, 2 ** 31 + 5, 0)
    run.jobs = [Job(0.0, 0.0, 0.0, inputs, {})]
    run.trace, run.host_s = yardstick.Trace([], 0.0), 1.0
    return run


def test_spans_on_jobs_of_a_toy_sweep(checkout):
    """The spans-on jobs in a process of their own, on the CPU; the run's
    own process never turns spans on."""
    run = _toy_run(checkout)
    lines = []
    spans.record(run, log=lambda *a, **k: lines.append(a[0]))
    assert not profiling._on and profiling.drain_spans() == []
    steps = run.spec.driver.steps(run.spec.config, run.spec.traffic)
    for got in (run.spans, run.traced_spans):
        names = [s.name for s in got]
        assert names.count("sweep.job") == 1 and names.count("sweep.init") == 1
        assert names.count("sweep.step") == steps and names.count("sweep.finish") == 1
        assert len({s.root_id for s in got}) == 1
    assert lines[0].startswith("spans: ") and "with spans off" in lines[0]
    assert "device idle s by innermost open span" in lines[1]
    got = {m: _reader(m).read(run) for m in SPAN_METRICS}
    assert got["span_ms.sweep_init"] > 0 and got["span_ms.sweep_step"] > 0
    # no kernel wrapper on the CPU, no launch call and no device operation
    assert {m: v for m, v in got.items() if v is None} == {m: None for m in SPAN_METRICS[2:]}


def test_traced_run_on_the_cpu_reads_no_span_metric_and_leaves_spans_off(checkout):
    result, correct = _run(checkout, "tiny_sweep", trace=True)
    assert correct
    assert not set(SPAN_METRICS) & set(result["metrics"])
    assert not profiling._on and profiling.drain_spans() == []


def test_a_program_without_spans_reads_none_and_runs_nothing(checkout, monkeypatch):
    run = _toy_run(checkout)
    run.device = torch.device("cuda")  # as on a card: only the program's lack of spans stops the jobs
    monkeypatch.delattr(profiling, "drain_spans")
    monkeypatch.setattr(spans, "record", lambda *a, **k: pytest.fail("jobs run without the program's spans"))
    t0 = time.perf_counter()
    assert all(_reader(m).read(run) is None for m in SPAN_METRICS)
    assert time.perf_counter() - t0 < 5
