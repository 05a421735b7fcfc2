"""Profiling hooks (counterpart of ``qmps_tpu.utils.profiling``):
``torch.profiler`` traces and a throughput counter."""
from __future__ import annotations

import contextlib
import os
import tempfile
import time

import torch


@contextlib.contextmanager
def trace(log_dir: str | None = None):
    """Profile a block with ``torch.profiler``: the CPU activity, and the
    CUDA activity where there is a card.  Writes the Chrome trace (open it
    in Perfetto or chrome://tracing) to ``<log_dir>/trace.json``; None is
    a new directory under the temporary directory.  Yields log_dir."""
    log_dir = log_dir or tempfile.mkdtemp(prefix="qmps_torch_trace_")
    os.makedirs(log_dir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield log_dir
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def _synchronize(result) -> None:
    """Wait for the devices of the CUDA tensors in ``result`` (a tensor or
    a tuple, list or dict of them)."""
    if isinstance(result, torch.Tensor):
        if result.is_cuda:
            torch.cuda.synchronize(result.device)
    elif isinstance(result, dict):
        for v in result.values():
            _synchronize(v)
    elif isinstance(result, (tuple, list)):
        for v in result:
            _synchronize(v)


class Throughput:
    """steps/sec (or evals/sec) counter; ``rate(result)`` first waits for
    the card that computes ``result``."""

    def __init__(self, unit: str = "steps"):
        self.unit = unit
        self.n = 0
        self.t0 = None

    def start(self):
        self.t0 = time.perf_counter()
        self.n = 0
        return self

    def tick(self, k: int = 1):
        self.n += k

    def rate(self, result=None) -> float:
        if result is not None:
            _synchronize(result)
        dt = time.perf_counter() - self.t0
        return self.n / dt if dt > 0 else float("inf")
