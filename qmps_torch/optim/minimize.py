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

The scipy bridge waits (ROADMAP.md, "The rest").
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch


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
