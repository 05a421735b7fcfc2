"""Gradient optimizers as PyTorch loops (counterpart of
``qmps_tpu.optim.minimize``).

- ``adam_steps`` / ``minimize_adam``: optax.adam's update (b1 0.9, b2
  0.999, eps 1e-8 outside the square root, bias correction), which is the
  formula ``torch.optim.Adam`` computes; the fused single-launch form on
  CUDA.  ``minimize_adam`` decays the rate as optax's
  ``cosine_decay_schedule(lr, steps, alpha=0.05)``; ``exponential_decay``
  is optax's non-staircase ``exponential_decay`` as a ``schedule``.
- ``minimize_lbfgs``: ``torch.optim.LBFGS`` (memory 10, strong-Wolfe line
  search).  optax's L-BFGS (zoom line search) cannot be matched iterate
  for iterate, so parity is held on the converged value (ROADMAP.md,
  "Faults in the port against the reference").
- ``minimize_scipy``: the bridge to scipy.optimize.minimize (the
  reference's Nelder-Mead and Powell, qmps/tools.py:212-219); the loss is
  evaluated without gradients unless ``with_grad``.  A stateful objective
  (fresh shot noise every evaluation) needs nothing special: nothing is
  traced.
- ``minimize_bayesian``: the reference's ``skopt.gp_minimize`` hook
  (qmps/tools.py:259-260), with the JAX package's numpy GP-EI loop where
  skopt is missing, seeded by an integer.
- ``retry_until_monotone``: rerun until the result does not regress.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch

from ..config import default_dtypes, resolve_device


@dataclasses.dataclass
class OptResult:
    """The fields qMPS consumers read off scipy's OptimizeResult."""

    x: torch.Tensor
    fun: float
    history: torch.Tensor | None = None
    nit: int = 0
    message: str = ""


def cosine_decay(steps: int, alpha: float = 0.05) -> Callable[[int], float]:
    """optax.cosine_decay_schedule's factor at update k (of init_value)."""
    return lambda k: (1 - alpha) * 0.5 * (1 + math.cos(math.pi * min(k, steps) / steps)) + alpha


def exponential_decay(steps: int, rate: float) -> Callable[[int], float]:
    """optax.exponential_decay(lr, steps, rate)'s factor at update k (of
    lr): rate ** (k / steps), without staircase."""
    return lambda k: rate ** (k / steps)


def adam_steps(loss: Callable, x0: torch.Tensor, steps: int, lr: float,
               schedule: Callable[[int], float] | None = None, record: bool = False):
    """``steps`` adam updates of x0 (a fresh optimizer state) on the scalar
    ``loss``; the rate is lr, or lr * schedule(k) at update k.  Returns
    (x, the pre-update losses (steps,) if ``record`` else None)."""
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


@torch.no_grad()
def _final(loss, x) -> float:
    return float(loss(x))


def minimize_adam(loss: Callable, x0: torch.Tensor, steps: int = 1000, lr: float = 1e-2,
                  store_values: bool = True) -> OptResult:
    """Adam with the cosine-decayed rate; ``fun`` is the returned x's loss."""
    x, hist = adam_steps(loss, x0, steps, lr, cosine_decay(steps), record=store_values)
    return OptResult(x=x, fun=_final(loss, x), history=hist, nit=steps, message="adam completed")


def minimize_lbfgs(loss: Callable, x0: torch.Tensor, steps: int = 200,
                   store_values: bool = True) -> OptResult:
    """L-BFGS, at most ``steps`` iterations; ``history`` holds the loss of
    every evaluation (the line search evaluates more than once per step)."""
    x = x0.detach().clone().requires_grad_()
    opt = torch.optim.LBFGS(
        [x], lr=1.0, max_iter=steps, history_size=10, line_search_fn="strong_wolfe"
    )
    hist = []

    def closure():
        opt.zero_grad(set_to_none=True)
        value = loss(x)
        value.backward()
        if store_values:
            hist.append(value.detach())
        return value

    opt.step(closure)
    nit = opt.state[opt.param_groups[0]["params"][0]]["n_iter"]
    x = x.detach()
    return OptResult(x=x, fun=_final(loss, x), history=torch.stack(hist) if store_values else None,
                     nit=nit, message="lbfgs completed")


def retry_until_monotone(run_once: Callable, generator: torch.Generator | None = None, max_tries: int = 3,
                         eps: float = 1e-4, last_best: float = float("inf")):
    """Numerical fault handling: rerun an optimization until its result
    does not regress past the previous best (the reference's
    retry-until-monotone loops, scripts/ground_state_finding.py:139-154,
    scripts/noisy_optimization.py).  ``run_once(generator) -> OptResult``
    draws its start from the generator, which each try advances (a CPU
    generator, seed 0, if None).  Returns the best finite result."""
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    best = None
    for _ in range(max_tries):
        res = run_once(generator)
        if math.isfinite(res.fun) and (best is None or res.fun < best.fun):
            best = res
        if best is not None and best.fun < last_best + eps:
            break
    return best


def minimize_bayesian(loss: Callable, bounds, n_calls: int = 40, n_init: int = 8, seed: int = 0,
                      n_candidates: int = 512, device=None) -> OptResult:
    """Bayesian optimization over box bounds (the reference's
    ``skopt.gp_minimize`` hook, qmps/tools.py:259-260, ``bayesian=True``):
    skopt where it is importable, else a GP (RBF kernel) with expected
    improvement in numpy, from ``np.random.default_rng(seed)``.  ``loss``
    takes a real tensor on ``device`` (the card unless asked,
    ``config.resolve_device``) in its real type (``config.default_dtypes``);
    the result's x lies there too."""
    import numpy as np

    device = resolve_device(device)
    _, rdtype = default_dtypes(device)

    def to_t(x):
        return torch.as_tensor(np.asarray(x, float)).to(device, rdtype)

    def f(x):
        with torch.no_grad():
            return float(loss(to_t(x)))

    def result(x, fun, message):
        return OptResult(x=to_t(x), fun=float(fun), nit=n_calls, message=message)

    lo = np.asarray([b[0] for b in bounds], float)
    hi = np.asarray([b[1] for b in bounds], float)
    d = lo.shape[0]
    try:  # the reference's own dependency, where present
        from skopt import gp_minimize

        res = gp_minimize(f, list(map(tuple, zip(lo, hi))), n_calls=n_calls)
        return result(res.x, res.fun, "skopt gp_minimize")
    except ImportError:
        pass

    rng = np.random.default_rng(seed)

    def scale(u):  # [0, 1]^d -> the box
        return lo + u * (hi - lo)

    X = list(rng.random((n_init, d)))
    y = [f(scale(u)) for u in X]
    sqrt2pi = float(np.sqrt(2 * np.pi))

    def _phi(z):
        return np.exp(-0.5 * z**2) / sqrt2pi

    def _Phi(z):
        return 0.5 * (1.0 + np.vectorize(math.erf)(z / np.sqrt(2.0)))

    for _ in range(n_calls - n_init):
        Xa = np.stack(X)
        ya = np.asarray(y)
        mu0, sd0 = ya.mean(), max(ya.std(), 1e-12)
        yn = (ya - mu0) / sd0
        ell = 0.25 * np.sqrt(d)
        d2 = ((Xa[:, None, :] - Xa[None, :, :]) ** 2).sum(-1)
        K = np.exp(-0.5 * d2 / ell**2) + 1e-8 * np.eye(len(X))
        Lc = np.linalg.cholesky(K)
        alpha = np.linalg.solve(Lc.T, np.linalg.solve(Lc, yn))
        # candidates: uniform, and local perturbations of the incumbent
        best_u = Xa[int(np.argmin(ya))]
        cand = np.concatenate([
            rng.random((n_candidates // 2, d)),
            np.clip(best_u + 0.1 * rng.standard_normal((n_candidates // 2, d)), 0.0, 1.0),
        ])
        kc = np.exp(-0.5 * ((cand[:, None, :] - Xa[None, :, :]) ** 2).sum(-1) / ell**2)
        mu = kc @ alpha
        v = np.linalg.solve(Lc, kc.T)
        sd = np.sqrt(np.clip(1.0 - (v**2).sum(0), 1e-12, None))
        ybest = yn.min()
        z = (ybest - mu) / sd
        ei = (ybest - mu) * _Phi(z) + sd * _phi(z)
        u = cand[int(np.argmax(ei))]
        X.append(u)
        y.append(f(scale(u)))

    i = int(np.argmin(y))
    return result(scale(X[i]), y[i], "builtin GP-EI")


def minimize_scipy(loss: Callable, x0, method: str = "Nelder-Mead", tol: float = 1e-8,
                   maxiter: int = 10000, with_grad: bool = False, device=None) -> OptResult:
    """scipy.optimize.minimize on a loss of tensors (the reference's
    optimizer settings, qmps/tools.py:212-219): scipy's float64 iterates
    go to ``device`` (``config.resolve_device``: x0's for a tensor, else
    the card) in x0's real type for a tensor, else the device's
    (``config.default_dtypes``); the loss comes back as a float; with
    ``with_grad`` its autograd gradient is scipy's jac."""
    import numpy as np
    from scipy.optimize import minimize as sp_minimize

    device = resolve_device(device, x0)
    rdtype = x0.dtype if isinstance(x0, torch.Tensor) else default_dtypes(device)[1]
    x0 = torch.as_tensor(x0)

    def to_t(x):
        return torch.as_tensor(np.asarray(x, float)).to(device, rdtype)

    def f(x):
        with torch.no_grad():
            return float(loss(to_t(x)))

    jac = None
    if with_grad:
        def jac(x):
            xt = to_t(x).requires_grad_()
            loss(xt).backward()
            return xt.grad.detach().cpu().double().numpy()

    res = sp_minimize(f, x0.detach().cpu().double().numpy(), method=method, tol=tol, jac=jac,
                      options={"maxiter": maxiter})
    return OptResult(x=to_t(res.x), fun=float(res.fun), nit=int(res.get("nit", 0)), message=str(res.message))
