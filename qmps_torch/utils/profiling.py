"""Profiling hooks (counterpart of ``qmps_tpu.utils.profiling``):
``torch.profiler`` traces and the program's spans.

A span is one named stretch of host time at a layer boundary of the
program: the sweep drivers' job, start, steps and pick (the fused and the
Stiefel sweep's), the chart sweep's job, descents, steps (the circuit's
build, the energy, the backward) and evaluations, the energy objective's
forward and backward, each kernel wrapper's call.  Spans are
off by default; ``span(name)`` then costs one flag read and returns a
shared empty context.  With ``spans_on()`` each span is appended, as it
closes, to a list in memory; ``drain_spans()`` returns and clears it.

Spans are stamped with ``time.time_ns()``, the clock of the profiler's
host events (kineto stamps them on the system's real-time clock), so a
span lines up with a ``torch.profiler`` trace of the same stretch without
a conversion.  A span's parent is the innermost span open in its thread;
a span opened with none open is a root, and every span under it carries
its id as ``root_id``.  A span opened in another thread (autograd's
device thread runs a CUDA backward, a sharded sweep's shards run in
threads of their own) is a root of its own.
"""
from __future__ import annotations

import contextlib
import itertools
import json
import os
import tempfile
import threading
import time
from typing import NamedTuple

import torch


class Span(NamedTuple):
    id: int
    parent_id: int | None
    root_id: int
    name: str
    start_ns: int
    end_ns: int
    thread_id: int


_on = False
_OFF = contextlib.nullcontext()
_spans: list[tuple] = []  # Span fields, made into Spans when drained
_ids = itertools.count(1)
_open = threading.local()  # .stack: the spans open in this thread, innermost last; .tid: its id


def _stack() -> list:
    try:
        return _open.stack
    except AttributeError:
        _open.stack, _open.tid = [], threading.get_native_id()
        return _open.stack


class _OpenSpan:
    __slots__ = ("name", "id", "parent_id", "root_id", "start_ns")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        stack = _stack()
        self.id = next(_ids)
        if stack:
            self.parent_id, self.root_id = stack[-1].id, stack[-1].root_id
        else:
            self.parent_id, self.root_id = None, self.id
        stack.append(self)
        self.start_ns = time.time_ns()
        return self

    def __exit__(self, *exc):
        end = time.time_ns()
        _open.stack.pop()
        _spans.append((self.id, self.parent_id, self.root_id, self.name, self.start_ns, end, _open.tid))
        return False


def span(name: str):
    """A context manager that records the span ``name`` while spans are on."""
    if not _on:
        return _OFF
    return _OpenSpan(name)


def spans_on() -> None:
    global _on
    _on = True


def spans_off() -> None:
    global _on
    _on = False


def drain_spans() -> list[Span]:
    """The spans recorded since the last drain, in the order they closed;
    the record is cleared."""
    out = _spans[:]
    del _spans[:len(out)]
    return [Span._make(t) for t in out]


@contextlib.contextmanager
def trace(log_dir: str | None = None):
    """Profile a block with ``torch.profiler``: the CPU activity, and the
    CUDA activity where there is a card, with the program's spans on.
    Writes the Chrome trace (open it in Perfetto or chrome://tracing) to
    ``<log_dir>/trace.json``, the spans among its events as complete
    events of category ``span``; None is a new directory under the
    temporary directory.  Yields log_dir."""
    log_dir = log_dir or tempfile.mkdtemp(prefix="qmps_torch_trace_")
    os.makedirs(log_dir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    was_on, mark = _on, len(_spans)
    spans_on()
    try:
        with torch.profiler.profile(activities=activities) as prof:
            yield log_dir
    finally:
        if not was_on:
            spans_off()
    recorded = [Span._make(t) for t in _spans[mark:]]
    if not was_on:  # the block's spans belong to its trace alone
        del _spans[mark:]
    path = os.path.join(log_dir, "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        doc = json.load(f)
    doc["traceEvents"] += _chrome_events(recorded, doc.get("baseTimeNanoseconds", 0))
    with open(path, "w") as f:
        json.dump(doc, f)


def _chrome_events(spans, base_ns: int = 0) -> list[dict]:
    """Spans as Chrome-trace complete events, in microseconds after
    ``base_ns`` (a profiler trace's ``baseTimeNanoseconds``)."""
    pid = os.getpid()
    return [{"ph": "X", "cat": "span", "name": s.name, "pid": pid, "tid": s.thread_id,
             "ts": (s.start_ns - base_ns) / 1e3, "dur": (s.end_ns - s.start_ns) / 1e3,
             "args": {"id": s.id, "parent_id": s.parent_id, "root_id": s.root_id}} for s in spans]
