"""Light observability: convergence records and wall-clock timers
(counterpart of ``qmps_tpu.utils.logging``; the reference printed and
kept obj_fun_values lists, qmps/tools.py:235-246)."""
from __future__ import annotations

import dataclasses
import time
from typing import List


@dataclasses.dataclass
class ConvergenceRecord:
    values: List[float] = dataclasses.field(default_factory=list)
    times: List[float] = dataclasses.field(default_factory=list)
    _t0: float = dataclasses.field(default_factory=time.perf_counter)

    def append(self, v: float):
        self.values.append(float(v))
        self.times.append(time.perf_counter() - self._t0)

    @property
    def best(self):
        return min(self.values) if self.values else None

    def steps_per_sec(self):
        if len(self.times) < 2:
            return 0.0
        return (len(self.times) - 1) / (self.times[-1] - self.times[0])


def plot_convergence(record_or_values, path: str | None = None, title: str = ""):
    """Convergence plot (the reference's Optimizer.plot_convergence,
    qmps/tools.py:272-284), headless: saves to ``path`` (or returns the
    figure).  matplotlib is imported here, on call."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    values = getattr(record_or_values, "values", record_or_values)
    fig, ax = plt.subplots(figsize=(5, 3.2))
    ax.plot(range(len(values)), list(values), lw=1.2)
    ax.set_xlabel("iteration")
    ax.set_ylabel("objective")
    if title:
        ax.set_title(title)
    fig.tight_layout()
    if path is not None:
        fig.savefig(path, dpi=120)
        plt.close(fig)
        return path
    return fig


class Timer:
    def __init__(self, name: str = ""):
        self.name = name

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *a):
        self.elapsed = time.perf_counter() - self.t0
