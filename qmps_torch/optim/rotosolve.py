"""Rotosolve and double rotosolve (counterpart of
``qmps_tpu.optim.rotosolve``).

The reference's double_rotosolve (qmps/tools.py:422-457) fits, a
coordinate at a time, the exact 2-harmonic section f(x) = P sin(2x + u) +
Q sin(x + v) from 5 evaluations and minimizes it with scipy's
minimize_scalar.  Here the 5-point stencil is the same and the 1-D
minimization is the JAX package's: a 512-point grid and 8 clipped Newton
steps, exact to rounding for this family, in numpy float64 on the host.
The loss is evaluated without gradients; the coordinate loop is a host
loop (the JAX package's fori_loop inside one program is a compile-time
form of the same loop).
"""
from __future__ import annotations

import math
from typing import Callable

import numpy as np
import torch


def _min_two_harmonic(P, u, Q, v, n_grid: int = 512) -> float:
    """argmin over [-pi, pi) of P sin(2x + u) + Q sin(x + v)."""
    xs = np.linspace(-np.pi, np.pi, n_grid, endpoint=False)
    x = xs[np.argmin(P * np.sin(2 * xs + u) + Q * np.sin(xs + v))]
    for _ in range(8):
        d1 = 2 * P * np.cos(2 * x + u) + Q * np.cos(x + v)
        d2 = -4 * P * np.sin(2 * x + u) - Q * np.sin(x + v)
        step = d1 / max(d2, 1e-12) if d2 > 1e-12 else 0.0
        x = x - np.clip(step, -0.1, 0.1)
    return float(x)


def _wrap(th: float) -> float:
    return math.atan2(math.sin(th), math.cos(th))


@torch.no_grad()
def rotosolve_step(loss: Callable, params: torch.Tensor) -> torch.Tensor:
    """One sweep of single-harmonic rotosolve (qmps/rotosolve.py:154-181):
    each theta_i to the argmin of the exact sinusoid through 3
    evaluations."""
    p = params.detach().clone()
    for i in range(p.shape[0]):
        def f(x):
            q = p.clone()
            q[i] += x
            return float(loss(q))

        f0, fp, fm = f(0.0), f(math.pi / 2), f(-math.pi / 2)
        p[i] += _wrap(-math.pi / 2 - math.atan2(2 * f0 - fp - fm, fp - fm))
    return p


@torch.no_grad()
def double_rotosolve_step(loss: Callable, params: torch.Tensor) -> torch.Tensor:
    """One sweep of 2-harmonic rotosolve with the reference's 5-point
    stencil (qmps/tools.py:431-452)."""
    p = params.detach().clone()
    for i in range(p.shape[0]):
        def M(x):
            q = p.clone()
            q[i] += x
            return float(loss(q))

        m0, mpi = M(0.0), M(math.pi)
        mp2, mm2 = M(math.pi / 2), M(-math.pi / 2)
        E = M(math.pi / 4) - M(-math.pi / 4)
        A, B, C, D = m0 + mpi, m0 - mpi, mp2 + mm2, mp2 - mm2
        a = (2 * E - math.sqrt(2.0) * D) / 4
        b = (A - C) / 4
        c, d = D / 2, B / 2
        th = _min_two_harmonic(math.hypot(a, b), math.atan2(b, a), math.hypot(c, d), math.atan2(d, c))
        p[i] += _wrap(th)
    return p


def rotosolve(loss: Callable, x0: torch.Tensor, n_sweeps: int = 100, double: bool = True):
    """Rotosolve for ``n_sweeps`` coordinate sweeps.  Returns (params, the
    loss after each sweep (n_sweeps,))."""
    step = double_rotosolve_step if double else rotosolve_step
    p, hist = x0.detach(), []
    for _ in range(n_sweeps):
        p = step(loss, p)
        with torch.no_grad():
            hist.append(loss(p).detach())
    return p, torch.stack(hist)


def double_rotosolve(loss: Callable, x0: torch.Tensor, n_sweeps: int = 100):
    return rotosolve(loss, x0, n_sweeps, double=True)

