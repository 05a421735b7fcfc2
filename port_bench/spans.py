"""The program's spans in a traced run, and the arithmetic of the metrics
that read them.

After the traced run's pair of jobs (``harness._profile``: one timed with
spans off, one profiled with spans off), :func:`record` runs two more jobs
of the window's first inputs with the program's spans on
(``qmps_torch.utils.profiling``): one unprofiled, whose spans are
``run.spans``, and one profiled, whose spans are ``run.traced_spans`` and
whose trace is ``run.span_trace`` (a :class:`SpanTrace`).  It prints on
standard error the spans' cost (the spans-on job's host time against the
spans-off one's, ``run.host_s``) and the device's idle time by the
innermost program span open across it.

The two jobs run in a process of their own (``python -m port_bench.spans``,
the cell's set-up first), because a process that has run a CUDA profiler
session stays slower: on an H100 a g16384 sweep took 5.7-6.2 s after one,
4.0-5.2 s before, and dropping the trace and collecting did not help.  Spans
are never turned on in the run's own process.

The spans are stamped with ``time.time_ns()``, the clock of the profiler's
host events, so a span and a launch call compare without a conversion.

A program without spans (an earlier tree), or a run on the CPU, where the
spans would time the CPU's kernels, records nothing, and every span
metric's reader returns None.
"""
from __future__ import annotations

import bisect
import os
import pickle
import statistics
import subprocess
import sys
import time
from pathlib import Path

from . import yardstick

#: the name under which time outside every span is reported
NO_SPAN = "(no span)"
#: the checkout whose ``port_bench`` and program this module is
HOME = Path(__file__).resolve().parent.parent


class SpanTrace:
    """What a profiled job's trace gives the span metrics: the host start of
    each launch call (``launch_starts_ns``, sorted) and the idle gaps between
    device operations (``idle_gaps_ns``, sorted (start, end))."""

    def __init__(self, events):
        """``events`` as ``yardstick.Trace`` takes them."""
        self.launch_starts_ns = sorted(a for on_device, _, name, a, _ in events
                                       if not on_device and name in yardstick.LAUNCH_CALLS)
        self.idle_gaps_ns, end = [], None
        for a, b in sorted((a, b) for on_device, _, _, a, b in events if on_device):
            if end is not None and a > end:
                self.idle_gaps_ns.append((end, a))
            end = b if end is None else max(end, b)


def _has_spans() -> bool:
    """Whether the program records spans."""
    try:
        from qmps_torch.utils import profiling
    except ImportError:
        return False
    return hasattr(profiling, "drain_spans")


def available(run) -> bool:
    """Whether ``run`` carries the spans-on jobs, running them on first
    call: only in a traced run on a card, with a program that has spans."""
    if not hasattr(run, "spans"):
        run.spans = run.traced_spans = run.span_trace = None
        if run.trace is not None and run.device.type == "cuda" and _has_spans():
            record(run)
    return run.spans is not None


def record(run, log=print) -> None:
    """Run the two spans-on jobs of the window's first inputs in a process
    of their own (see the module's docstring) and keep what they recorded
    on ``run``."""
    spec = run.spec
    request = {"driver": spec.driver.__file__, "config": spec.config, "traffic": spec.traffic,
               "device": str(run.device), "inputs": run.jobs[0].inputs}
    r, w = os.pipe()
    with subprocess.Popen([sys.executable, "-m", "port_bench.spans", str(w)], cwd=HOME, stdin=subprocess.PIPE,
                          pass_fds=(w,)) as proc:
        os.close(w)
        proc.stdin.write(pickle.dumps(request))
        proc.stdin.close()
        with os.fdopen(r, "rb") as f:
            got = f.read()
    if proc.returncode != 0 or not got:
        raise RuntimeError(f"the spans-on jobs failed (exit code {proc.returncode})")
    host_s, run.spans, run.traced_spans, run.span_trace = pickle.loads(got)
    over = 100.0 * (host_s / run.host_s - 1.0) if run.host_s > 0 else float("nan")
    log(f"spans: {len(run.spans)} spans a job; the job with spans on {host_s:.4f} s against {run.host_s:.4f} s "
        f"with spans off ({over:+.2f}%)", file=sys.stderr)
    idle = idle_by_innermost(run.span_trace.idle_gaps_ns, run.traced_spans)
    log("spans: device idle s by innermost open span: "
        + ", ".join(f"{n} {s:.4f}" for n, s in sorted(idle.items(), key=lambda x: -x[1])), file=sys.stderr)


def spans_on_jobs(driver: str, cfg: dict, cell: dict, device, inputs) -> tuple:
    """The cell's set-up by its job driver (the file ``driver``), then one
    job of ``inputs`` with spans on and one more profiled: (the first's host
    time, its spans, the second's spans, its SpanTrace).  Spans are off
    again afterwards."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from qmps_torch.utils import profiling

    from .harness import _sync, load_module

    drv, device = load_module(Path(driver), "port_bench_spans_driver"), torch.device(device)
    state = drv.setup(cfg, cell, 0, device)
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
    profiling.drain_spans()
    profiling.spans_on()
    try:
        _sync(device)
        t0 = time.perf_counter()
        drv.run_job(state, inputs)
        host_s = time.perf_counter() - t0
        spans = profiling.drain_spans()
        with profile(activities=activities) as p:
            drv.run_job(state, inputs)
            _sync(device)
        traced = profiling.drain_spans()
    finally:
        profiling.spans_off()
        profiling.drain_spans()
    return host_s, spans, traced, SpanTrace(yardstick.profile_events(p))


def _main(fd: int) -> None:
    """The spans-on jobs' process: the request (a pickle written by
    :func:`record`) on standard input, the result to the pipe ``fd``."""
    request = pickle.load(sys.stdin.buffer)
    result = spans_on_jobs(request["driver"], request["config"], request["traffic"], request["device"],
                           request["inputs"])
    with os.fdopen(fd, "wb") as f:
        f.write(pickle.dumps(result))


# ---------------------------------------------------------------------------
# the arithmetic
# ---------------------------------------------------------------------------


def intervals(spans, name: str) -> list:
    """The union of the named spans' (start_ns, end_ns), sorted and
    disjoint."""
    out = []
    for a, b in sorted((s.start_ns, s.end_ns) for s in spans if s.name == name):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def count_inside(times_ns, spans_union) -> int:
    """How many of the sorted ``times_ns`` lie inside the disjoint
    intervals ``spans_union``."""
    return sum(bisect.bisect_right(times_ns, b) - bisect.bisect_left(times_ns, a) for a, b in spans_union)


def overlap_ns(gaps, spans_union) -> int:
    """The time the sorted, disjoint intervals ``gaps`` and ``spans_union``
    share."""
    total, j = 0, 0
    for a, b in gaps:
        while j < len(spans_union) and spans_union[j][1] <= a:
            j += 1
        k = j
        while k < len(spans_union) and spans_union[k][0] < b:
            total += min(b, spans_union[k][1]) - max(a, spans_union[k][0])
            k += 1
    return total


def self_ns(spans) -> dict:
    """Each span's duration less the durations of its child spans, by id."""
    own = {s.id: s.end_ns - s.start_ns for s in spans}
    for s in spans:
        if s.parent_id in own:
            own[s.parent_id] -= s.end_ns - s.start_ns
    return own


def idle_by_innermost(gaps, spans) -> dict:
    """Idle seconds of ``gaps`` by the name of the innermost span open
    across them (the open span that opened last, over all threads);
    ``NO_SPAN`` where none is open."""
    bounds = sorted({t for s in spans for t in (s.start_ns, s.end_ns)})
    # the innermost open span of each stretch between consecutive bounds
    by_start = sorted(spans, key=lambda s: s.start_ns)
    segments, open_, i = [], [], 0
    for a, b in zip(bounds, bounds[1:]):
        while i < len(by_start) and by_start[i].start_ns <= a:
            open_.append(by_start[i])
            i += 1
        open_ = [s for s in open_ if s.end_ns > a]
        # ids grow in the order spans open: a child that opens at its parent's start is inner
        segments.append((a, b, max(open_, key=lambda s: (s.start_ns, s.id)).name if open_ else NO_SPAN))
    out, j = {}, 0
    for a, b in gaps:
        covered = 0
        while j < len(segments) and segments[j][1] <= a:
            j += 1
        k = j
        while k < len(segments) and segments[k][0] < b:
            d = min(b, segments[k][1]) - max(a, segments[k][0])
            out[segments[k][2]] = out.get(segments[k][2], 0.0) + d / 1e9
            covered += d
            k += 1
        if covered < b - a:
            out[NO_SPAN] = out.get(NO_SPAN, 0.0) + (b - a - covered) / 1e9
    return out


# ---------------------------------------------------------------------------
# the readers' common forms
# ---------------------------------------------------------------------------


def durations_ms(run, name: str) -> list:
    if not available(run):
        return []
    return [(s.end_ns - s.start_ns) / 1e6 for s in run.spans if s.name == name]


def launches_in(run, name: str) -> tuple[int, int] | None:
    """(launch calls of the spans-on profiled job whose host start lies in a
    span ``name``, the number of such spans); None without spans or
    launches."""
    if not available(run) or not run.span_trace.launch_starts_ns:
        return None
    n = sum(1 for s in run.traced_spans if s.name == name)
    if n == 0:
        return None
    return count_inside(run.span_trace.launch_starts_ns, intervals(run.traced_spans, name)), n


def idle_pct_in(run, name: str) -> float | None:
    """Share (%) of the spans-on profiled job's idle-gap time during which a
    span ``name`` is open; None without spans or gaps."""
    if not available(run):
        return None
    gaps = run.span_trace.idle_gaps_ns
    total = sum(b - a for a, b in gaps)
    if total == 0 or not any(s.name == name for s in run.traced_spans):
        return None
    return 100.0 * overlap_ns(gaps, intervals(run.traced_spans, name)) / total


def kernel_self_us(run) -> list:
    """Self time (us) of each ``kernel.*`` span of the spans-on job."""
    if not available(run):
        return []
    own = self_ns(run.spans)
    return [own[s.id] / 1e3 for s in run.spans if s.name.startswith("kernel.")]


def median(values) -> float | None:
    return statistics.median(values) if values else None


if __name__ == "__main__":
    from port_bench import spans  # the result's classes pickled under their module's own name

    spans._main(int(sys.argv[1]))
