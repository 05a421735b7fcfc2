"""The program's spans (``qmps_torch.utils.profiling``): off by default and
then recording nothing, the fused sweep's job, start, steps and pick with
their parents and root, the energy objective and the kernel wrappers'
spans, the Stiefel sweep's job, chunks, start, steps (with their energy,
backward and retraction; on the CPU never a replay or a capture) and pick,
the chart sweep's job, descents, steps (with their build, energy and
backward) and evaluations, every sweep's results bit for bit the same with
spans on and off, ``adam_steps``'s span seam (the quench's results
unchanged), the chart readers of ``port_bench/metrics`` on a trace without
their spans, and the kernels' one launch path (``_lib.launch``) against a
fake library.
"""
import ast
import contextlib
import pathlib
import threading

import pytest
import torch
from _torch_parity import stiefel_advance_span_counts

from qmps_torch.kernels import _lib
from qmps_torch.optim import minimize
from qmps_torch.parallel import sweep_ground_states, sweep_ground_states_fused, sweep_ground_states_stiefel
from qmps_torch.utils import profiling

REPO = pathlib.Path(__file__).resolve().parents[1]
KERNELS = REPO / "qmps_torch" / "kernels"
CHART_READERS = ["span_ms.chart_step", "span_launches.chart_step", "span_idle_pct.chart_step",
                 "span_ms.chart_evaluate"]


@pytest.fixture
def spans():
    """Spans on for the test, off and drained after it."""
    profiling.drain_spans()
    profiling.spans_on()
    try:
        yield
    finally:
        profiling.spans_off()
        profiling.drain_spans()


def _sweep(steps=3):
    return sweep_ground_states_fused(torch.tensor([0.4, 1.1], dtype=torch.float64), steps=steps, restarts=2,
                                     generator=torch.Generator().manual_seed(7), iters=24)


def test_spans_are_off_by_default_and_record_nothing():
    assert not profiling._on
    profiling.drain_spans()
    _sweep()
    assert profiling.drain_spans() == []
    assert profiling.span("a") is profiling.span("b")  # one shared empty context


def test_sweep_records_its_job_start_steps_and_pick(spans):
    _sweep(steps=3)
    got = profiling.drain_spans()
    by_name = {}
    for s in got:
        by_name.setdefault(s.name, []).append(s)
    assert {k: len(v) for k, v in by_name.items() if k.startswith("sweep.")} == {
        "sweep.job": 1, "sweep.init": 1, "sweep.step": 3, "sweep.finish": 1}
    (job,) = by_name["sweep.job"]
    assert job.parent_id is None and job.root_id == job.id
    assert all(s.root_id == job.id for s in got)  # one sweep, one request, one thread on the CPU
    assert all(s.start_ns <= s.end_ns for s in got)
    ids = {s.id: s for s in got}
    for s in by_name["sweep.init"] + by_name["sweep.step"] + by_name["sweep.finish"]:
        assert s.parent_id == job.id
    # each step's forward and backward, and the pick's forward
    assert len(by_name["energy.forward"]) == 4 and len(by_name["energy.backward"]) == 3
    assert {ids[s.parent_id].name for s in by_name["energy.forward"]} == {"sweep.step", "sweep.finish"}
    assert {ids[s.parent_id].name for s in by_name["energy.backward"]} == {"sweep.step"}
    for s in got:  # a child lies inside its parent
        if s.parent_id is not None:
            p = ids[s.parent_id]
            assert p.start_ns <= s.start_ns <= s.end_ns <= p.end_ns
    steps = sorted(by_name["sweep.step"], key=lambda s: s.start_ns)
    assert all(a.end_ns <= b.start_ns for a, b in zip(steps, steps[1:]))
    assert profiling.drain_spans() == []  # drained


def test_results_are_bitwise_the_same_with_spans_on_and_off():
    e0, A0 = _sweep(steps=4)
    profiling.spans_on()
    try:
        e1, A1 = _sweep(steps=4)
    finally:
        profiling.spans_off()
        profiling.drain_spans()
    assert torch.equal(e0, e1) and torch.equal(A0, A1)


def _stiefel(steps=3, point_chunk=2):
    return sweep_ground_states_stiefel(torch.tensor([0.4, 0.9, 1.1, 1.6], dtype=torch.float64), D=4, steps=steps,
                                       generator=torch.Generator().manual_seed(7), recycle_iters=4, final_iters=10,
                                       point_chunk=point_chunk)


def test_stiefel_spans_are_off_by_default_and_results_are_bitwise_the_same():
    assert not profiling._on
    profiling.drain_spans()
    out0 = _stiefel()
    assert profiling.drain_spans() == []
    profiling.spans_on()
    try:
        out1 = _stiefel()
    finally:
        profiling.spans_off()
        profiling.drain_spans()
    assert all(torch.equal(a, b) for a, b in zip(out0, out1))


def test_stiefel_sweep_records_its_job_chunks_start_steps_and_pick(spans):
    """Two chunks of two points, 3 steps: the job; a chunk span for each
    chunk in each of the sweep's two calls (the descent; the polish steps,
    none here, and the pick); one start a chunk; one step a step a chunk,
    each holding its energy, backward and retraction; one pick a chunk."""
    _stiefel(steps=3, point_chunk=2)
    got = profiling.drain_spans()
    ids = {s.id: s for s in got}
    by_name = {}
    for s in got:
        by_name.setdefault(s.name, []).append(s)
    assert {k: len(v) for k, v in by_name.items()} == {
        "stiefel.job": 1, "stiefel.chunk": 4, "stiefel.init": 2, "stiefel.step": 6, "stiefel.energy": 6,
        "stiefel.backward": 6, "stiefel.retract": 6, "stiefel.finish": 2}
    (job,) = by_name["stiefel.job"]
    assert job.parent_id is None and all(s.root_id == job.id for s in got)
    parent = {name: {ids[s.parent_id].name for s in by_name[name]} for name in by_name if name != "stiefel.job"}
    assert parent == {"stiefel.chunk": {"stiefel.job"}, "stiefel.init": {"stiefel.chunk"},
                      "stiefel.step": {"stiefel.chunk"}, "stiefel.finish": {"stiefel.chunk"},
                      "stiefel.energy": {"stiefel.step"}, "stiefel.backward": {"stiefel.step"},
                      "stiefel.retract": {"stiefel.step"}}
    chunks = sorted(by_name["stiefel.chunk"], key=lambda s: s.start_ns)
    for c, (n_init, n_steps, n_finish) in zip(chunks, [(1, 3, 0), (1, 3, 0), (0, 0, 1), (0, 0, 1)]):
        kids = [s.name for s in got if s.parent_id == c.id]
        assert (kids.count("stiefel.init"), kids.count("stiefel.step"), kids.count("stiefel.finish")) == \
            (n_init, n_steps, n_finish)
    for s in got:  # a child lies inside its parent
        if s.parent_id is not None:
            p = ids[s.parent_id]
            assert p.start_ns <= s.start_ns <= s.end_ns <= p.end_ns
    for step in by_name["stiefel.step"]:  # energy, then backward, then retraction
        kids = sorted((s for s in got if s.parent_id == step.id), key=lambda s: s.start_ns)
        assert [s.name for s in kids] == ["stiefel.energy", "stiefel.backward", "stiefel.retract"]
        assert all(a.end_ns <= b.start_ns for a, b in zip(kids, kids[1:]))


def test_stiefel_advance_on_the_cpu_steps_eagerly_with_no_replay_or_capture():
    """On the CPU every step runs eagerly: ten steps, each with its energy,
    backward and retraction, and no ``stiefel.replay`` or
    ``stiefel.capture`` (a card's graphed descent: tests/test_torch_cuda.py)."""
    assert stiefel_advance_span_counts(torch.device("cpu"), 10) == {
        "stiefel.step": 10, "stiefel.energy": 10, "stiefel.backward": 10, "stiefel.retract": 10}


def _chart(steps=3, recycle=None):
    """The "deep_bw" chart sweep at D = 4 on 4 points, 2 refine passes:
    five descents (the random start, then each pass both ways)."""
    return sweep_ground_states(torch.tensor([0.4, 0.9, 1.1, 1.6], dtype=torch.float64), D=4, ansatz="deep_bw",
                               steps=steps, refine_passes=2, generator=torch.Generator().manual_seed(7),
                               recycle=recycle)


def test_chart_spans_are_off_by_default_and_results_are_bitwise_the_same():
    assert not profiling._on
    profiling.drain_spans()
    out0 = _chart()
    assert profiling.drain_spans() == []
    profiling.spans_on()
    try:
        out1 = _chart()
        assert profiling.drain_spans()
    finally:
        profiling.spans_off()
        profiling.drain_spans()
    assert all(torch.equal(a, b) for a, b in zip(out0, out1))


@pytest.mark.parametrize("recycle", [True, False])
def test_chart_sweep_records_its_job_descents_steps_and_evaluations(spans, recycle):
    """3 steps a descent, 2 refine passes, one chunk: the job; one
    ``chart.optimize`` a descent (5); one ``chart.step`` a step (15), each
    holding its build, energy and backward in that order; one
    ``chart.evaluate`` for each descent's final read (5, inside its
    descent) and each neighbour evaluation (4, inside the job); a build and
    an energy inside each evaluation, and one more pair inside the job, the
    probe of one row's saved tensors that sizes the chunks."""
    _chart(3, recycle)
    got = profiling.drain_spans()
    ids = {s.id: s for s in got}
    by_name = {}
    for s in got:
        by_name.setdefault(s.name, []).append(s)
    assert {k: len(v) for k, v in by_name.items()} == {
        "chart.job": 1, "chart.optimize": 5, "chart.step": 15, "chart.backward": 15, "chart.evaluate": 9,
        "chart.build": 15 + 9 + 1, "chart.energy": 15 + 9 + 1}
    (job,) = by_name["chart.job"]
    assert job.parent_id is None and all(s.root_id == job.id for s in got)

    def parents(name):
        return sorted(ids[s.parent_id].name for s in by_name[name])

    assert parents("chart.optimize") == ["chart.job"] * 5
    assert parents("chart.step") == ["chart.optimize"] * 15
    assert parents("chart.backward") == ["chart.step"] * 15
    assert parents("chart.evaluate") == ["chart.job"] * 4 + ["chart.optimize"] * 5
    assert parents("chart.build") == parents("chart.energy") == sorted(
        ["chart.evaluate"] * 9 + ["chart.job"] + ["chart.step"] * 15)
    for s in got:  # a child lies inside its parent
        if s.parent_id is not None:
            p = ids[s.parent_id]
            assert p.start_ns <= s.start_ns <= s.end_ns <= p.end_ns
    for step in by_name["chart.step"]:  # build, then energy, then backward
        kids = sorted((s for s in got if s.parent_id == step.id), key=lambda s: s.start_ns)
        assert [s.name for s in kids] == ["chart.build", "chart.energy", "chart.backward"]
    for opt in by_name["chart.optimize"]:  # the steps, then the final read
        kids = sorted((s for s in got if s.parent_id == opt.id), key=lambda s: s.start_ns)
        assert [s.name for s in kids] == ["chart.step"] * 3 + ["chart.evaluate"]


def _adam_steps_before_the_seam(loss, x0, steps, lr, schedule=None, record=False):
    """``adam_steps`` as it was before its span seam, verbatim."""
    x = x0.detach().clone().requires_grad_()
    opt = torch.optim.Adam([x], lr=lr, fused=x.is_cuda)
    sched = torch.optim.lr_scheduler.LambdaLR(opt, schedule) if schedule is not None else None
    hist = []
    for _ in range(steps):
        opt.zero_grad(set_to_none=True)
        value = loss(x)
        value.backward()
        opt.step()
        if sched is not None:
            sched.step()
        if record:
            hist.append(value.detach())
    return x.detach(), torch.stack(hist) if record else None


def test_adam_steps_seam_leaves_the_arithmetic_unchanged(spans):
    """With its spans named and on, ``adam_steps`` gives what the loop
    before the seam gives, bit for bit, and opens one step span a step
    with its backward inside."""
    w = torch.linspace(-1.0, 2.0, 6, dtype=torch.float64)

    def loss(x):
        return ((x - w) ** 2 * torch.cos(x)).sum()

    x0 = torch.zeros(6, dtype=torch.float64)
    want = _adam_steps_before_the_seam(loss, x0, 7, 0.1, minimize.cosine_decay(7), record=True)
    got = minimize.adam_steps(loss, x0, 7, 0.1, minimize.cosine_decay(7), record=True, spans=("s", "b"))
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    recorded = profiling.drain_spans()
    ids = {s.id: s for s in recorded}
    assert [s.name for s in recorded].count("s") == 7
    assert all(s.name == "s" or ids[s.parent_id].name == "s" for s in recorded)
    assert minimize.adam_steps(loss, x0, 7, 0.1)[0].equal(_adam_steps_before_the_seam(loss, x0, 7, 0.1)[0])


def test_the_quench_is_unchanged_by_the_seam(monkeypatch):
    """The quench family, whose inner steps and ground state run
    ``adam_steps``, gives the same overlaps bit for bit with the loop from
    before the seam put in its place."""
    from qmps_torch.algorithms import evolve

    def quench():
        return evolve.batched_quench_sweep(1.5, [0.2, 0.5], 0.1, 2, inner_steps=5, gs_steps=20,
                                           params0=torch.linspace(-0.5, 0.5, 15, dtype=torch.float64), device="cpu")

    t0, les0 = quench()
    monkeypatch.setattr(evolve, "adam_steps", _adam_steps_before_the_seam)
    monkeypatch.setattr(minimize, "adam_steps", _adam_steps_before_the_seam)
    t1, les1 = quench()
    assert torch.equal(torch.as_tensor(t0), torch.as_tensor(t1)) and torch.equal(les0, les1)


@pytest.mark.parametrize("name", CHART_READERS)
def test_chart_readers_read_nothing_without_their_spans(name):
    """Each chart reader gives None on a spans-on job whose spans hold no
    ``chart.*`` span (a program from before them: the fused sweep's), and
    on a run without spans at all."""
    from port_bench.harness import Run, load_module
    from port_bench.spans import SpanTrace

    reader = load_module(REPO / "port_bench" / "metrics" / f"{name}.py", f"port_bench_metric_{name}")
    ms = 1_000_000
    sp = [profiling.Span(1, None, 1, "sweep.job", 0, 10 * ms, 1), profiling.Span(2, 1, 1, "sweep.step", ms, 5 * ms, 1)]
    events = [(False, 1, "cudaLaunchKernel", 2 * ms, 2 * ms + 1000), (True, 7, "k", 3 * ms, 4 * ms),
              (True, 7, "k", 6 * ms, 7 * ms)]
    run = Run(None, torch.device("cuda"))
    run.spans, run.traced_spans, run.span_trace = sp, sp, SpanTrace(events)
    assert reader.read(run) is None
    run.spans = None
    assert reader.read(run) is None


@pytest.mark.parametrize("name,want", [("span_ms.chart_step", 3.0), ("span_launches.chart_step", 2.0),
                                       ("span_idle_pct.chart_step", 200 / 3), ("span_ms.chart_evaluate", 3.0)])
def test_chart_readers_on_synthetic_spans(name, want):
    """A job of 12 ms: a descent 1-10 ms with steps 1-3, 3-6 and 6-9 ms
    (median 3 ms) and its final read 9-10, a neighbour evaluation 10-12
    (evaluations 3 ms in all); launch calls at 2, 2.5, 4, 5, 7, 8 (in the
    steps: 2 a step) and 11 ms; device work 0-2, 4-10 and 11-12 ms, so
    idle 2-4 (in a step) and 10-11 (not): 2/3 of the idle time."""
    from port_bench.harness import Run, load_module
    from port_bench.spans import SpanTrace

    reader = load_module(REPO / "port_bench" / "metrics" / f"{name}.py", f"port_bench_metric_{name}")
    ms = 1_000_000
    sp = [profiling.Span(1, None, 1, "chart.job", 0, 12 * ms, 1),
          profiling.Span(2, 1, 1, "chart.optimize", ms, 10 * ms, 1)]
    sp += [profiling.Span(3 + i, 2, 1, "chart.step", a * ms, b * ms, 1) for i, (a, b) in enumerate([(1, 3), (3, 6),
                                                                                                      (6, 9)])]
    sp += [profiling.Span(6, 2, 1, "chart.evaluate", 9 * ms, 10 * ms, 1),
           profiling.Span(7, 1, 1, "chart.evaluate", 10 * ms, 12 * ms, 1)]
    events = [(False, 1, "cudaLaunchKernel", int(t * ms), int(t * ms) + 1000) for t in (2, 2.5, 4, 5, 7, 8, 11)]
    events += [(True, 7, "k", a * ms, b * ms) for a, b in ((0, 2), (4, 10), (11, 12))]
    run = Run(None, torch.device("cuda"))
    run.spans, run.traced_spans, run.span_trace = sp, sp, SpanTrace(events)
    assert reader.read(run) == pytest.approx(want)


def _worker():
    with profiling.span("worker"):
        pass


def test_a_span_in_another_thread_is_a_root_of_its_own(spans):
    with profiling.span("outer"):
        t = threading.Thread(target=_worker)
        t.start()
        t.join(timeout=30)
        with profiling.span("inner"):
            pass
    assert not t.is_alive()
    got = {s.name: s for s in profiling.drain_spans()}
    assert got["inner"].parent_id == got["outer"].id and got["inner"].root_id == got["outer"].id
    assert got["worker"].parent_id is None and got["worker"].root_id == got["worker"].id
    assert got["worker"].thread_id != got["outer"].thread_id == threading.get_native_id()


def test_a_launcher_opens_the_kernel_span(spans):
    calls = []

    @_lib.launcher("energy_fwd")
    def wrapper(x):
        calls.append(x)
        return 2 * x

    with profiling.span("caller"):
        assert wrapper(3) == 6
    got = {s.name: s for s in profiling.drain_spans()}
    assert calls == [3] and wrapper.__name__ == "wrapper"
    assert got["kernel.energy_fwd"].parent_id == got["caller"].id


def _calls(node, attr):
    return [c for c in ast.walk(node) if isinstance(c, ast.Call) and isinstance(c.func, ast.Attribute)
            and c.func.attr == attr and isinstance(c.func.value, ast.Name) and c.func.value.id == "_lib"]


def test_every_launch_counter_sits_in_its_launchers_span():
    """Each function that calls ``_lib.launch(<name>)``, which counts the
    launch, is decorated by ``_lib.launcher(<name>)``: the span and the
    counter share one boundary, for every key of ``_lib.launches``.  No
    other kernel module counts, calls the library or reads a stream or a
    device itself."""
    launched = set()
    for path in sorted(KERNELS.glob("*.py")):
        text = path.read_text()
        if path.name != "_lib.py":
            assert not any(s in text for s in ("lib().qmps_", ".cuda_stream", "torch.cuda.device(")), path.name
        for fn in ast.walk(ast.parse(text)):
            if not isinstance(fn, ast.FunctionDef):
                continue
            assert not _calls(fn, "count"), (path.name, fn.name)
            names = {c.args[0].value for c in _calls(fn, "launch")}
            if not names:
                continue
            spans = {c.args[0].value for d in fn.decorator_list for c in _calls(d, "launcher")}
            assert names == spans, (path.name, fn.name, names, spans)
            launched |= names
    assert launched == set(_lib.launches)


class _FakeLibrary:
    """A kernel library whose one entry point records its arguments and
    returns ``rc``."""

    def __init__(self, rc):
        self.rc, self.calls = rc, []

    def qmps_energy_fwd(self, *args):
        self.calls.append(args)
        return self.rc


_X, _Y = torch.zeros(3), torch.ones(2, 2)


@pytest.mark.parametrize("args, index, rc, expected", [
    pytest.param((_X, _Y, 5, 7), 0, 0, (_X.data_ptr(), _Y.data_ptr(), 5, 7), id="tensors_as_pointers"),
    pytest.param((_X, None, 5), 0, 0, (_X.data_ptr(), None, 5), id="none_as_null"),
    pytest.param((_X, 5), 1, 0, (_X.data_ptr(), 5), id="stream_of_the_given_card"),
    pytest.param((_X, 5), 0, 700, None, id="failure_raises_and_counts_nothing"),
    pytest.param((5,), 2, 0, (5,), id="success_counts_one"),
])
def test_launch_passes_the_calling_convention(monkeypatch, args, index, rc, expected):
    """``_lib.launch`` against a fake library on the CPU: the card current
    is 0 (``index`` 2 makes 2 current first), the stream of card i is
    1000 + i; the device guard is entered only off the current card."""
    current, entered = 2 if index == 2 else 0, []
    fake = _FakeLibrary(rc)

    @contextlib.contextmanager
    def guard(i):
        entered.append(i)
        yield

    monkeypatch.setattr(_lib, "_lib", fake)
    monkeypatch.setattr(_lib, "launches", dict.fromkeys(_lib.launches, 0))
    monkeypatch.setattr(torch.cuda, "current_device", lambda: current)
    monkeypatch.setattr(torch.cuda, "device", guard)
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream", lambda i: 1000 + i, raising=False)
    device = torch.device("cuda", index)
    if rc:
        with pytest.raises(RuntimeError, match="energy_fwd failed to launch: cudaError 700"):
            _lib.launch("energy_fwd", device, *args)
        assert not any(_lib.launches.values())
        return
    _lib.launch("energy_fwd", device, *args)
    assert fake.calls == [expected + (1000 + index,)]
    assert entered == ([index] if index != current else [])
    assert _lib.launches == {**dict.fromkeys(_lib.launches, 0), "energy_fwd": 1}


class _FakeUnrollLibrary:
    """The unroll's two C entry points, recording their arguments."""

    def __init__(self):
        self.calls = []

    def qmps_stiefel_unroll_fwd(self, *args):
        self.calls.append(("fwd",) + args)
        return 0

    def qmps_stiefel_unroll_bwd(self, *args):
        self.calls.append(("bwd",) + args)
        return 0


@pytest.mark.parametrize("save", [True, False], ids=["saving", "no_grad"])
def test_unroll_wrappers_open_their_kernel_spans_and_pass_the_c_order(monkeypatch, spans, save):
    """The unroll's wrappers against a fake library on the CPU (the card's
    checks of type and device waived): each runs inside its span
    ``kernel.stiefel_unroll_fwd`` / ``_bwd``, counts one launch, and hands
    the C entry point its pointers in order (the forward's saved iterates
    as null pointers when it saves nothing), then B, D and the iterations."""
    from qmps_torch.kernels import stiefel_unroll as su

    fake = _FakeUnrollLibrary()
    monkeypatch.setattr(_lib, "_lib", fake)
    monkeypatch.setattr(_lib, "require", lambda *a: None)
    monkeypatch.setattr(_lib, "launches", dict.fromkeys(_lib.launches, 0))
    monkeypatch.setattr(torch.cuda, "current_device", lambda: None)
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream", lambda i: 1000, raising=False)
    B, D, iters = 3, 4, 5
    V, r0 = torch.zeros(B, D, 2, D, dtype=torch.complex64), torch.zeros(B, D, D, dtype=torch.complex64)
    lam, r, rs, ns = su._fwd_cuda(V, r0, iters, save)
    assert (rs is None) == (ns is None) == (not save)
    if save:
        su._bwd_cuda(V, rs, ns, r, r0)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    want = [("fwd", ptr(V), ptr(r0), ptr(r), ptr(lam), ptr(rs), ptr(ns), B, D, iters, 1000)]
    if save:
        want.append(("bwd", ptr(V), ptr(rs), ptr(ns), ptr(r), ptr(r0)) + fake.calls[1][6:7] + (B, D, iters, 1000))
    assert fake.calls == want
    names = [s.name for s in profiling.drain_spans()]
    assert names == ["kernel.stiefel_unroll_fwd"] + ["kernel.stiefel_unroll_bwd"] * save
    assert _lib.launches == {**dict.fromkeys(_lib.launches, 0), "stiefel_unroll_fwd": 1,
                             "stiefel_unroll_bwd": int(save)}

