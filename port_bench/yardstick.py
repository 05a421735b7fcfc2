"""The benchmark's frozen arithmetic: the card's published peaks, the
roofline bound of a kernel's work, and the reading of a profiler trace
(host launch calls, device busy time, idle share, the breakdown).

The peaks are NVIDIA's H100 SXM data sheet at its full 700 W power limit
(dense rates): a card set to a lower limit (``nvidia-smi
--query-gpu=power.limit``) reaches less, and the run's result line names
the card.  The work counts, the bound and the idle arithmetic are
frozen copies of the repository's chip script (``csquare_flops``,
``solve_flops``, ``kernel_work``, ``bound``, ``device_breakdown``), so
that a later change to the program cannot move the yardstick.
"""
from __future__ import annotations

import bisect
import re

#: float32 on the CUDA cores, TF32 on the tensor cores (no kernel the cells
#: time uses them), device memory bytes/s; all at the full 700 W
PEAK_F32, PEAK_TF32, PEAK_BYTES = 67e12, 495e12, 3.35e12
CMAC, CMUL = 8, 6  # real flops of a complex multiply-add (4 FMAs) and of a product

#: host calls that put work on the device: each is one launch as the host
#: issues it (a CUDA graph's replay is one call however many kernels it holds)
LAUNCH_CALLS = frozenset({
    "cudaLaunchKernel", "cudaLaunchKernelExC", "cudaLaunchCooperativeKernel", "cuLaunchKernel",
    "cuLaunchKernelEx", "cuLaunchCooperativeKernel", "cudaGraphLaunch", "cuGraphLaunch",
})


def csquare_flops(N: int) -> int:
    """Real flops of the square of an N x N complex matrix R + iI in its
    three-product form: R R, I I and (R + I)(R + I) (6 N^3), N^2 adds
    before them and 3 N^2 after."""
    return 6 * N ** 3 + 4 * N * N


def solve_flops(iters: int) -> int:
    """The N = 4 dominant eigenpair by ``iters`` squarings: per squaring the
    square and the normalisation of its 16 entries (6 flops each), then
    three matvecs, the Rayleigh quotient and two norms."""
    return iters * (csquare_flops(4) + 16 * 6) + 52 * CMAC + 56


def objective_work(kernel: str, iters: int = 48) -> tuple[int, int]:
    """(flops, bytes) per element of one launch of the D = 2 objectives'
    kernels, each input byte read once and each output byte written once;
    K4 and K5 read a per-element gate W (128 B)."""
    aa, e = 16 * (CMUL + CMAC), 64 * CMAC  # the AA build, the E build
    w = 128
    return {
        "K2": (2 * aa + e + solve_flops(iters) + 64 * CMAC + 124, 64 + 128 + 4 + 8 + 32),
        # before the adjoint's series ~3,660, the series 24 x 80 multiply-adds, after it ~4,730
        "K3": (3656 + 24 * 80 * CMAC + 4732, 64 + 128 + 32 + 8 + 4 + 64 + 128),
        # two AA builds, WAA, E, one solve, the left vector off the power
        "K4": (2 * aa + 2 * e + solve_flops(iters) + 32 * CMAC + 32, 64 + 64 + 8 + 32 + 32 + w),
        # two AA builds, WAA, P and C, Wbar and Q, two AA-build adjoints, the coefficient
        "K5": (2 * aa + e + 2 * 96 * CMAC + 4 * 64 * CMAC + 60, 64 + 64 + 32 + 32 + 8 + 4 + 64 + 64 + 128 + w),
    }[kernel]


def bound_s(flops: float, nbytes: float) -> float:
    """The least time of a piece of work on the card: the larger of its
    float32 operations over the CUDA cores' peak and its bytes over the
    memory rate."""
    return max(flops / PEAK_F32, nbytes / PEAK_BYTES)


def kernel_roofline_pct(trace: "Trace", kernels: dict, batch: int) -> float | None:
    """Share (%) of the least time in the device time of a family of
    kernels: ``kernels`` maps a name pattern (searched in the device
    operation's name) to the (flops, bytes) one launch does per element;
    each traced launch of a pattern adds ``bound_s`` of ``batch`` elements.
    None where the trace holds no launch of the family."""
    least, spent = 0.0, 0.0
    for pattern, (flops, nbytes) in kernels.items():
        rx = re.compile(pattern)
        for name, seconds in trace.device_ops:
            if rx.search(name):
                least += bound_s(flops * batch, nbytes * batch)
                spent += seconds
    return 100.0 * least / spent if spent > 0 else None


def idle_pct(busy_s: float, host_s: float) -> float | None:
    """1 - device busy over the host time of the same work, in %: None where
    the device ran nothing."""
    if busy_s <= 0 or host_s <= 0:
        return None
    return 100.0 * (1.0 - busy_s / host_s)


class Trace:
    """What one profiled stretch of work shows: the host's launch calls,
    each device operation as (name, seconds), the union of the device
    operations' intervals (busy), the stretch's host time, and the idle
    gaps between device operations named by the host operation open
    across each gap's middle."""

    def __init__(self, events, window_s: float):
        """``events``: (device, thread, name, start_ns, end_ns) of every
        profiled event, device True for an operation on the card."""
        self.window_s = window_s
        self.launches = 0
        self.device_ops = []
        dev, host = [], []
        for on_device, thread, name, a, b in events:
            if on_device:
                dev.append((a, b, name))
                self.device_ops.append((name, (b - a) / 1e9))
            else:
                host.append((a, b, thread, name))
                if name in LAUNCH_CALLS:
                    self.launches += 1
        dev.sort()
        busy, end, gaps = 0, None, []
        for a, b, _ in dev:
            if end is not None and a > end:
                gaps.append((end, a))
            busy += max(0, b - max(a, end if end is not None else a))
            end = b if end is None else max(end, b)
        self.busy_s = busy / 1e9
        self.gaps = _name_gaps(gaps, host)

    def top_device_ops(self, k: int = 10) -> list:
        total = {}
        for name, s in self.device_ops:
            total[name] = total.get(name, 0.0) + s
        return sorted(([n, s] for n, s in total.items()), key=lambda x: -x[1])[:k]

    def top_idle_gaps(self, k: int = 10) -> list:
        total = {}
        for name, s in self.gaps:
            total[name] = total.get(name, 0.0) + s
        return sorted(([n, s] for n, s in total.items()), key=lambda x: -x[1])[:k]


def _name_gaps(gaps, host):
    """(host name, seconds) of each idle gap: the host event covering the
    gap's middle that started last, over all threads."""
    host.sort()
    starts = [h[0] for h in host]
    out = []
    for a, b in gaps:
        mid = (a + b) // 2
        i = bisect.bisect_right(starts, mid)
        best = None
        # the covering event that started last: walk back over the events
        # that start before the middle until one covers it (events nest, so
        # the first found is the innermost; the scan is bounded)
        for j in range(i - 1, max(-1, i - 4096), -1):
            s, e, _, name = host[j]
            if e >= mid:
                best = name
                break
        out.append((best or "(host between operations)", (b - a) / 1e9))
    return out


def profile_events(prof) -> list:
    """The (device, thread, name, start_ns, end_ns) tuples of a finished
    ``torch.profiler.profile``, read off its raw events; the ranges that
    ``record_function`` draws on the device's timeline are left out."""
    from torch.autograd import DeviceType

    out = []
    for e in prof.profiler.kineto_results.events():
        on_device = e.device_type() == DeviceType.CUDA
        if on_device and e.is_user_annotation():
            continue  # a host range drawn on the device's timeline, no operation
        a = e.start_ns()
        out.append((on_device, e.start_thread_id(), e.name(), a, a + e.duration_ns()))
    return out
