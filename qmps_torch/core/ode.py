"""Adaptive Dormand-Prince 5(4) integration, batched over trajectories
(the port's counterpart of ``jax.experimental.ode.odeint``, which
``qmps_tpu.algorithms.scars`` integrates its classical TDVP equations with).

``odeint`` reproduces JAX's algorithm (jax 0.9, ``jax/experimental/ode.py``)
step for step: the Dormand-Prince tableau with its FSAL stage
(``runge_kutta_step``), the Hairer-Norsett-Wanner initial step
(``initial_step_size``, order 4), the RMS error ratio against atol + rtol
max(|y0|, |y1|) (``mean_error_ratio``), the step controller with safety
0.9, growth at most 10 and shrinking at least to 0.2 only on a rejection
(``optimal_step_size``, order 5), at most ``mxstep`` attempts between two
output times, and the 4th-order Dormand-Prince interpolant at each output
time (``interp_fit_dopri``).

The leading dimensions of ``y0`` are a batch of independent trajectories,
and each keeps its own step size, acceptance, counter and interpolant:
what ``jax.vmap`` of JAX's while-loop gives, where a row whose loop has
ended keeps its state while other rows step.  All rows step together (one
batched right-hand side a stage); a row that has reached the output time
is masked out.  The loop ends when no row is active, which the host reads
after each step (a step with no row active changes nothing).  On CUDA a
step is one CUDA graph, replayed.

Everything runs in float64 on ``y0``'s device (JAX's scars code casts its
start to float64).  Forward only: nothing in either package differentiates
through it.
"""
from __future__ import annotations

import contextlib
import functools
import math
from typing import Callable

import torch

_ALPHA = (1 / 5, 3 / 10, 4 / 5, 8 / 9, 1.0, 1.0)
_BETA = (
    (1 / 5, 0, 0, 0, 0, 0, 0),
    (3 / 40, 9 / 40, 0, 0, 0, 0, 0),
    (44 / 45, -56 / 15, 32 / 9, 0, 0, 0, 0),
    (19372 / 6561, -25360 / 2187, 64448 / 6561, -212 / 729, 0, 0, 0),
    (9017 / 3168, -355 / 33, 46732 / 5247, 49 / 176, -5103 / 18656, 0, 0),
    (35 / 384, 0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84, 0),
)
_C_SOL = (35 / 384, 0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84, 0)
_C_ERR = (35 / 384 - 1951 / 21600, 0, 500 / 1113 - 22642 / 50085, 125 / 192 - 451 / 720,
          -2187 / 6784 - -12231 / 42400, 11 / 84 - 649 / 6300, -1.0 / 60.0)
_C_MID = (6025192743 / 30085553152 / 2, 0, 51252292925 / 65400821598 / 2,
          -2691868925 / 45128329728 / 2, 187940372067 / 1594534317056 / 2,
          -1776094331 / 19743644256 / 2, 11237099 / 235043384 / 2)


def _norm(x: torch.Tensor) -> torch.Tensor:
    return torch.linalg.vector_norm(x, dim=-1)


def _initial_step_size(fun, t0, y0, order, rtol, atol, f0):
    """Hairer, Norsett, Wanner, Solving ODEs I, Sec. II.4, a row at a time."""
    scale = atol + y0.abs() * rtol
    d0 = _norm(y0 / scale)
    d1 = _norm(f0 / scale)
    h0 = torch.where((d0 < 1e-5) | (d1 < 1e-5), torch.full_like(d0, 1e-6), 0.01 * d0 / d1)
    f1 = fun(y0 + h0[..., None] * f0, t0 + h0)
    d2 = _norm((f1 - f0) / scale) / h0
    h1 = torch.where((d1 <= 1e-15) & (d2 <= 1e-15), torch.clamp(h0 * 1e-3, min=1e-6),
                     (0.01 / torch.maximum(d1, d2)) ** (1.0 / (order + 1.0)))
    return torch.minimum(100.0 * h0, h1)


def _combine(w: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """sum_j w[j] k[..., j, :]: elementwise, so a row's result does not
    depend on the batch it is in."""
    return (w[:, None] * k).sum(-2)


def _runge_kutta_step(fun, y0, f0, t0, dt, tab):
    """One Dormand-Prince step: (y1, f1, error estimate, the 7 stages as
    (..., 7, n), zero where a stage is not yet filled)."""
    alpha, beta, c_sol, c_err = tab
    h = dt[..., None]
    k = torch.zeros(y0.shape[:-1] + (7, y0.shape[-1]), dtype=y0.dtype, device=y0.device)
    k[..., 0, :] = f0
    for i in range(6):
        k[..., i + 1, :] = fun(y0 + h * _combine(beta[i], k), t0 + dt * alpha[i])
    return h * _combine(c_sol, k) + y0, k[..., 6, :], h * _combine(c_err, k), k


def _mean_error_ratio(err, rtol, atol, y0, y1):
    tol = atol + rtol * torch.maximum(y0.abs(), y1.abs())
    return ((err / tol) ** 2).mean(-1).sqrt()


def _optimal_step_size(last, ratio, safety=0.9, ifactor=10.0, dfactor=0.2, order=5.0):
    dfactor = torch.where(ratio < 1, torch.ones_like(ratio), torch.full_like(ratio, dfactor))
    factor = torch.clamp(torch.maximum(ratio ** (-1.0 / order) * safety, dfactor), max=ifactor)
    return torch.where(ratio == 0, last * ifactor, last * factor)


def _interp_fit(y0, y1, k, dt, c_mid):
    """The quartic through a step: (a, b, c, d, e), highest power first."""
    h = dt[..., None]
    y_mid = y0 + h * _combine(c_mid, k)
    dy0, dy1 = k[..., 0, :], k[..., -1, :]
    a = -2.0 * h * dy0 + 2.0 * h * dy1 - 8.0 * y0 - 8.0 * y1 + 16.0 * y_mid
    b = 5.0 * h * dy0 - 3.0 * h * dy1 + 18.0 * y0 + 14.0 * y1 - 32.0 * y_mid
    c = -4.0 * h * dy0 + h * dy1 - 11.0 * y0 - 5.0 * y1 + 16.0 * y_mid
    return torch.stack([a, b, c, h * dy0, y0], -2)


def odeint(func: Callable, y0, t, rtol: float = 1.4e-8, atol: float = 1.4e-8, mxstep=math.inf,
           hmax=math.inf) -> torch.Tensor:
    """Integrate dy/dt = func(y, t) from y(t[0]) = y0 and return y at each
    time of ``t`` (strictly increasing), shape (len(t),) + y0.shape.

    ``y0`` is (..., n): each leading index one trajectory, integrated with
    its own adaptive steps.  ``func(y, t)`` takes y of that shape and t of
    shape (...), one time a trajectory, and returns dy/dt shaped as y.  On
    CUDA a step is one CUDA graph, captured once and replayed (a step is
    ~350 small operations whose launches would otherwise cost the host
    more than the card's work): ``func`` must then be capturable (no host
    reads)."""
    y0 = torch.as_tensor(y0, dtype=torch.float64)
    dev = y0.device
    ts = torch.as_tensor(t, dtype=torch.float64, device=dev)
    tab = tuple(torch.tensor(x, dtype=torch.float64, device=dev) for x in (_ALPHA, _BETA, _C_SOL, _C_ERR))
    c_mid = torch.tensor(_C_MID, dtype=torch.float64, device=dev)
    batch = y0.shape[:-1]

    t0 = ts[0].expand(batch)
    f = func(y0, t0)
    # the loop's state: each step reads and rewrites these tensors in place
    st = {
        "y": y0.clone(), "f": f.clone(), "t": t0.clone(), "last_t": t0.clone(),
        "dt": torch.clamp(_initial_step_size(func, t0, y0, 4, rtol, atol, f), min=0.0, max=hmax),
        "coeff": y0[..., None, :].expand(batch + (5, y0.shape[-1])).clone(),
        "i": torch.zeros(batch, dtype=torch.int64, device=dev), "target": ts[0].clone(),
        "still": torch.zeros((), dtype=torch.bool, device=dev),
    }

    def stepping():
        on = (st["t"] < st["target"]) & (st["dt"] > 0)
        return on & (st["i"] < mxstep) if mxstep != math.inf else on

    def step():
        y, f, t_cur, dt = st["y"], st["f"], st["t"], st["dt"]
        active = stepping()
        y1, f1, err, k = _runge_kutta_step(func, y, f, t_cur, dt, tab)
        ratio = _mean_error_ratio(err, rtol, atol, y, y1)
        take = active & (ratio <= 1.0)
        st["coeff"].copy_(torch.where(take[..., None, None], _interp_fit(y, y1, k, dt, c_mid), st["coeff"]))
        st["last_t"].copy_(torch.where(take, t_cur, st["last_t"]))
        new_t = torch.where(take, t_cur + dt, t_cur)
        new_dt = torch.where(active, torch.clamp(_optimal_step_size(dt, ratio), min=0.0, max=hmax), dt)
        y.copy_(torch.where(take[..., None], y1, y))
        f.copy_(torch.where(take[..., None], f1, f))
        t_cur.copy_(new_t)
        dt.copy_(new_dt)
        st["i"].add_(active)
        st["still"].copy_(stepping().any())

    run = step
    out = [y0]
    for target in ts[1:]:
        st["target"].copy_(target)
        st["i"].zero_()
        while True:
            if dev.type == "cuda" and run is step:
                run = _graphed(step)  # its warm-up calls are this target's first steps
            run()
            if not bool(st["still"]):
                break
        s = ((st["target"] - st["last_t"]) / (st["t"] - st["last_t"]))[..., None]
        coeff = st["coeff"]
        yt = coeff[..., 0, :]
        for j in range(1, 5):
            yt = yt * s + coeff[..., j, :]
        out.append(yt)
    return torch.stack(out)


@functools.cache
def _capture_stream(device: int) -> torch.cuda.Stream:
    """The side stream of every capture on card ``device``, its warm-ups'
    too.  cuBLAS keeps a 32 MiB workspace for each stream and handle it
    has run on, for the life of the process: a new stream for each capture
    left two more behind every time (64 MiB for a D = 16 descent)."""
    return torch.cuda.Stream(device)


def _graphed(fn: Callable, warm: Callable | None = None, capture=contextlib.nullcontext) -> Callable:
    """``fn`` (which only rewrites tensors in place) run twice on a side
    stream, as capture requires, then captured there as a CUDA graph:
    returns its replay.  ``warm`` (``fn`` if None) is called for each
    warm-up, a caller's wrapper of ``fn`` that counts them; the capture runs
    inside ``capture()``.  ``torch.cuda.graph`` empties the allocator's
    cache before it captures, so the graph's pool takes the room the
    warm-ups left."""
    warm = warm or fn
    side = _capture_stream(torch.cuda.current_device())
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        warm()
        warm()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with capture(), torch.cuda.graph(graph, stream=side):
        fn()
    return graph.replay
