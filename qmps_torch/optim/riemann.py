"""Riemannian optimization on the isometry (Stiefel) manifold (counterpart
of ``qmps_tpu.optim.riemann``).

The variational object is the MPS isometry itself, V in St(dD, D) =
{V : V^dag V = I}: gradient -> tangent projection -> heavy-ball step ->
polar retraction (SVD).  For a real loss of complex V, torch's ``.grad``
is already the steepest-descent direction, conj(jax.grad): the JAX
package's ``G.conj()`` (riemann.py:65, :168) has no counterpart here.
"""
from __future__ import annotations

from typing import Callable

import torch

from ..config import default_dtypes, resolve_device
from ..core.linalg import _trace
from ..mps import transfer as tr
from ..mps.imps import merge


def _project_tangent(V: torch.Tensor, G: torch.Tensor) -> torch.Tensor:
    """Project a Euclidean gradient G onto the tangent space of St at V:
    G - V sym(V^dag G)."""
    VG = V.mH @ G
    return G - V @ ((VG + VG.mH) / 2)


def _retract(V: torch.Tensor) -> torch.Tensor:
    """Polar retraction back onto the manifold (SVD)."""
    u, _, vh = torch.linalg.svd(V, full_matrices=False)
    return u @ vh


def _descent_step(V, M, G, lr: float, momentum: float, retract: Callable = _retract):
    """One heavy-ball step in the tangent space with a polar retraction
    (``retract``: the SVD's here, the batched sweeps' closed-form 2x2 or
    Newton-Schulz one); the momentum is re-projected after the retraction
    (vector transport by projection)."""
    M = momentum * M + _project_tangent(V, G)
    V = retract(V - lr * M)
    return V, _project_tangent(V, M)


def stiefel_minimize(loss: Callable, V0: torch.Tensor, steps: int = 300, lr: float = 0.1,
                     momentum: float = 0.9):
    """Minimize loss(V) over isometries V (orthonormal columns).

    Returns (V, history); history has steps + 1 entries, hist[k] the loss
    at iterate k and hist[-1] the loss of the returned V (reported
    energies are achieved by the returned state)."""
    V, M = V0, torch.zeros_like(V0)
    hist = []
    for _ in range(steps):
        with torch.enable_grad():
            Vg = V.detach().requires_grad_()
            val = loss(Vg)
            (G,) = torch.autograd.grad(val, Vg)
        with torch.no_grad():
            V, M = _descent_step(V, M, G, lr, momentum)
        hist.append(val.detach())
    with torch.no_grad():
        hist.append(loss(V))
    return V, torch.stack(hist)


def _tensor(V: torch.Tensor, D: int) -> torch.Tensor:
    """The (..., d, D, D) MPS tensor of (..., dD, D) isometries: rows of V
    are indexed (i, s), matching ``unitary_to_tensor``'s column slice."""
    return V.reshape(V.shape[:-2] + (D, 2, D)).transpose(-3, -2)


def _energy(A: torch.Tensor, r: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """Real energy density sum h[t, s] tr(A2[s] r A2[t]^dag) with r
    hermitized and given unit trace."""
    r = (r + r.mH) / 2
    r = r / _trace(r)[..., None, None]
    A2 = merge(A, A)
    return torch.einsum("...ts,...sij,...jk,...tik->...", h.to(A.dtype), A2, r, A2.conj()).real


def isometry_energy(V: torch.Tensor, h: torch.Tensor, D: int, dense: bool, power_iters: int = 120):
    """Energy density of the uMPS whose tensor is the (..., dD, D)
    isometry V; the environment by dense repeated squaring (``dense``) or
    by the matvec Krylov path (restarted Arnoldi, GMRES adjoint)."""
    A = _tensor(V, D)
    _, r = tr.right_fixed_point(A, A, dense=dense, iters=40 if dense else power_iters)
    return _energy(A, r, h)


def isometry_energy_warm(V: torch.Tensor, h: torch.Tensor, D: int, r0: torch.Tensor, iters: int = 24,
                         bwd: str = "auto"):
    """(energy, r): ``isometry_energy`` with environment recycling, the
    fixed point warm-started at r0 (the previous step's environment;
    detach it at the call site).  ``bwd``: the implicit adjoint's solver
    ("auto", "lu", "gmres"; ``transfer.right_eigpair_warm``) or "unroll",
    plain autograd through the warm iterations (the batched sweeps: the
    LU branch builds a (D^2+1)^2 system per batch element)."""
    A = _tensor(V, D)
    if bwd == "unroll":
        _, r = tr.right_eigpair_warm_unroll(A, A, r0, iters)
    else:
        _, r = tr.right_eigpair_warm(A, A, r0, iters, bwd)
    return _energy(A, r, h), r


def _recycled_descent(V0: torch.Tensor, h: torch.Tensor, D: int, steps: int, lr: float, momentum: float,
                      recycle_iters: int):
    """The recycled program (qmps_tpu/optim/riemann.py:133-192) from V0:
    the environment rides the descent and is refined by ``recycle_iters``
    warm matvecs a step; the last history entry is a 200-iteration
    refinement at the returned V (residual ~1e-15), never the recycled
    residual.  Returns (V, hist)."""
    r = torch.eye(D, dtype=V0.dtype, device=V0.device) / D ** 0.5
    V, M = V0, torch.zeros_like(V0)
    hist = []
    for _ in range(steps):
        with torch.enable_grad():
            Vg = V.detach().requires_grad_()
            val, r_new = isometry_energy_warm(Vg, h, D, r, recycle_iters)
            (G,) = torch.autograd.grad(val, Vg)
        with torch.no_grad():
            V, M = _descent_step(V, M, G, lr, momentum)
        hist.append(val.detach())
        r = r_new.detach()
    with torch.no_grad():
        hist.append(isometry_energy_warm(V, h, D, r, 200)[0])
    return V, torch.stack(hist)


def ground_state_riemannian(h, D: int, steps: int = 400, lr: float = 0.08,
                            generator: torch.Generator | None = None, dense_env_max_D: int | None = None,
                            power_iters: int | None = None, recycle: bool = True, recycle_iters: int = 24,
                            device=None):
    """Variational uMPS ground state at bond dimension D, optimizing the
    (dD, D) isometry directly.

    ``recycle`` (default): environment recycling, ``recycle_iters`` warm
    power matvecs a step (``transfer.right_eigpair_warm``, its implicit
    adjoint by LU up to D = 32 and by GMRES above).  ``recycle=False``: a
    cold solve every step, dense repeated squaring up to
    ``dense_env_max_D`` and the matvec Krylov path above it; the default
    crossover is 8 on the CPU (the JAX package's CPU value) and 32 on
    CUDA (its accelerator value; the card's crossover is not measured).
    ``dense_env_max_D`` and ``power_iters`` configure the cold solver
    only, and raise with ``recycle=True``.

    ``h`` the (4, 4) two-site Hamiltonian; the start isometry is the QR of
    complex normals drawn from ``generator`` (a CPU generator, seed 0 if
    None); ``device`` as ``config.resolve_device``, the working precision
    ``config.default_dtypes`` (a tensor h sets it).

    Returns (A (d, D, D), energy, history); ``energy`` = hist[-1] is
    evaluated at the returned A.
    """
    device = resolve_device(device, h)
    cdtype, _ = default_dtypes(device, h if isinstance(h, torch.Tensor) else None)
    h = torch.as_tensor(h).to(device, cdtype)
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    x = torch.randn((2, 2 * D, D), generator=generator, dtype=torch.float64)
    V0, _ = torch.linalg.qr(torch.complex(x[0], x[1]).to(device, cdtype))
    if recycle:
        if dense_env_max_D is not None or power_iters is not None:
            raise ValueError("dense_env_max_D/power_iters configure the cold per-step "
                             "solver; pass recycle=False to use them")
        V, hist = _recycled_descent(V0, h, D, steps, lr, 0.9, recycle_iters)
    else:
        if dense_env_max_D is None:
            dense_env_max_D = 32 if device.type == "cuda" else 8
        dense = D <= dense_env_max_D
        iters = 120 if power_iters is None else power_iters
        V, hist = stiefel_minimize(lambda V: isometry_energy(V, h, D, dense, iters), V0, steps=steps, lr=lr)
    return _tensor(V, D), float(hist[-1]), hist
