"""The D = 2 phase-diagram sweep (counterpart of ``qmps_tpu.parallel.sweep``).

A sweep is one batch: every point and every restart is one row of the
(B, 4, 2) isometry batch, optimized together; the fused energy objective
(kernels/energy_fused.py) evaluates the whole batch's energies and
gradients in one forward and one backward launch per step.
"""
from __future__ import annotations

import torch

from ..config import default_dtypes, resolve_device
from ..core.paulis import I2, X, Z
from ..kernels.energy_fused import energy_objective_fused


def tfim_matrix(g: torch.Tensor) -> torch.Tensor:
    """TFIM 2-site matrix -ZZ + g (XI + IX)/2, real, for a scalar or a
    batch of g (..., 4, 4), on g's device and in g's type."""
    zz = torch.kron(Z, Z).real.to(g)
    xx = (torch.kron(X, I2) + torch.kron(I2, X)).real.to(g)
    return -zz + g[..., None, None] / 2.0 * xx


def sweep_ground_states_fused(
    gs,
    steps: int = 300,
    lr: float = 0.1,
    momentum: float = 0.9,
    restarts: int = 1,
    generator: torch.Generator | None = None,
    iters: int = 48,
    device=None,
):
    """The D = 2 phase-diagram sweep with the fused energy objective:
    heavy-ball Riemannian descent on the (4, 2) MPS isometry of every
    (point, restart) — tangent projection, retraction by the closed-form
    2x2 polar factor — for ``steps`` steps, then the best of ``restarts``
    per point.

    ``gs`` (n,) couplings; ``generator`` draws the starting isometries (a
    CPU ``torch.Generator``, seed 0 if None); ``device`` defaults to gs's
    for a tensor, else to the card (``config.resolve_device``).  On the
    CPU the sweep runs in complex128 with the plain objective, on CUDA in
    complex64 with the kernels.

    Returns (energies (n,), As (n, 2, 2, 2) left-canonical tensors).
    """
    device = resolve_device(device, gs)
    _, rdtype = default_dtypes(device)
    gs = torch.as_tensor(gs, dtype=rdtype, device=device)
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    Bt = gs.shape[0] * restarts
    xre = torch.randn((Bt, 4, 2), generator=generator, dtype=torch.float64)
    xim = torch.randn((Bt, 4, 2), generator=generator, dtype=torch.float64)
    xre, xim = xre.to(device, rdtype), xim.to(device, rdtype)

    init, advance, finish = _fused_sweep_programs(lr, momentum, restarts, iters)
    hs, V, M = init(gs, xre, xim)
    V, M = advance(V, M, hs, steps)
    return finish(V, hs)


def _fused_sweep_programs(lr, momentum, restarts, iters):
    """(init, advance, finish) of sweep_ground_states_fused.  They take
    and return plain tensors, so a caller can start them from any state —
    the JAX package's included (utils/convert.py)."""

    def loss(V, hs):
        A = V.reshape(-1, 2, 2, 2).transpose(1, 2)  # (B, s, i, j)
        return energy_objective_fused(A, hs, iters)

    def sym_proj(V, G):
        VG = V.mH @ G
        return G - V @ ((VG + VG.mH) / 2)

    def polar(W):
        H = W.mH @ W  # (B, 2, 2) PSD
        t = (H[:, 0, 0] + H[:, 1, 1]).real
        dt = (H[:, 0, 0] * H[:, 1, 1] - H[:, 0, 1] * H[:, 1, 0]).real
        # scale-relative det floor (qmps_tpu/parallel/sweep.py:512-518): a
        # rank-deficient W yields a bounded rank-1 factor, not f32 overflow
        dt = torch.maximum(dt, (1e-6 * t) ** 2)
        s = torch.sqrt(dt)
        # sqrt(H) = (H + s I)/sqrt(t + 2s); inverse by the 2x2 adjugate
        denom = torch.sqrt(torch.clamp(t + 2.0 * s, min=1e-30))
        HsI = H + s[:, None, None] * torch.eye(2, dtype=H.dtype, device=H.device)
        detHsI = torch.clamp(
            (HsI[:, 0, 0] * HsI[:, 1, 1] - HsI[:, 0, 1] * HsI[:, 1, 0]).real, min=1e-30
        )
        adj = torch.stack(
            [
                torch.stack([HsI[:, 1, 1], -HsI[:, 0, 1]], -1),
                torch.stack([-HsI[:, 1, 0], HsI[:, 0, 0]], -1),
            ],
            -2,
        )
        return W @ (adj * (denom / detHsI)[:, None, None])

    def init(gs, xre, xim):
        """(hs (B, 4, 4) real, V0 (B, 4, 2), M0 = 0) with B = n restarts."""
        n = gs.shape[0]
        hs = tfim_matrix(gs.to(xre))
        hs = hs[:, None].expand(n, restarts, 4, 4).reshape(-1, 4, 4)
        V0, _ = torch.linalg.qr(torch.complex(xre, xim))
        return hs, V0, torch.zeros_like(V0)

    def advance(V, M, hs, length):
        """``length`` heavy-ball steps on (V, M)."""
        for _ in range(length):
            with torch.enable_grad():
                Vg = V.detach().requires_grad_()
                # torch's .grad is already conj(jax.grad): sweep.py:559's
                # G.conj() is not needed here
                (G,) = torch.autograd.grad(loss(Vg, hs).sum(), Vg)
            with torch.no_grad():
                M = momentum * M + sym_proj(V, G)
                V = polar(V - lr * M)
                M = sym_proj(V, M)
        return V, M

    @torch.no_grad()
    def finish(V, hs):
        """Best of the restarts: (energies (n,), As (n, 2, 2, 2))."""
        er = loss(V, hs).reshape(-1, restarts)
        i = torch.argmin(er, dim=1)
        Vbest = V.reshape(-1, restarts, 4, 2)[torch.arange(er.shape[0], device=V.device), i]
        return er.min(dim=1).values, Vbest.reshape(-1, 2, 2, 2).transpose(1, 2).contiguous()

    return init, advance, finish
