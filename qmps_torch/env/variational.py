"""Variational environments (counterpart of ``qmps_tpu.env.variational``).

Ported: the gen-2 M-ansatz matching ``represent_variational_M``
(ClassicalTDVPStripped.py:599-655), the brickwork Represent.  The gen-1
tomography and trace-distance solvers wait (ROADMAP.md, "The rest").
"""
from __future__ import annotations

import math

import torch

from ..circuits.brickwork import env_M, right_env_map
from ..optim.minimize import adam_steps, exponential_decay


def represent_variational_M(U1, U2, U1d, U2d, p0=None, steps: int = 400, lr: float = 5e-2,
                            eta_bounds=None):
    """Gen-2 variational environment: minimize |eta M(p) - E[M(p)]|_F^2
    over (eta, 6 params) by adam with the rate decayed as optax's
    exponential_decay(lr, steps // 2, 0.03) (Represent.cost_function,
    ClassicalTDVPStripped.py:614-636).  The residual is squared: the
    reference's norm has a gradient singularity at the optimum.

    ``eta_bounds=(lo, hi)`` reparametrizes eta = lo + (hi - lo)
    sigmoid(x), the dt-bounded eta of loschmidt_classical.py:196-219.
    ``p0`` (7,) real defaults to (1, pi/4, 0, 0, 0, 0, 0); the run is on
    the bricks' device, in the real type of their complex type.
    Returns (eta, M, the residual norm)."""
    rdtype = U1.real.dtype
    if p0 is None:
        p0 = torch.tensor([1.0, math.pi / 4, 0, 0, 0, 0, 0], dtype=torch.float64)
    p0 = torch.as_tensor(p0).to(U1.device, rdtype)

    def eta_of(x):
        if eta_bounds is None:
            return x
        lo, hi = eta_bounds
        return lo + (hi - lo) * torch.sigmoid(x)

    def loss(params):
        eta, M = eta_of(params[0]), env_M(params[1:])
        return (eta * M - right_env_map(U1, U2, U1d, U2d, M)).abs().square().sum()

    v, _ = adam_steps(loss, p0, steps, lr, exponential_decay(max(steps // 2, 1), 0.03))
    with torch.no_grad():
        return eta_of(v[0]), env_M(v[1:]), loss(v).sqrt()
