"""Phase-diagram sweeps (counterpart of ``qmps_tpu.parallel.sweep``).

A sweep is one batch: every point and every restart is one row of the
batch, optimized together.
- The chart sweeps (``sweep_ground_states``): adam over the parameters
  of a state ansatz ("suN", "deep_bw", "full15" or a shallow circuit),
  the summed energy of the batch descended by one fused adam (each row's
  gradient is its own point's, and adam is elementwise, as the JAX
  package's vmap of optax's is); environment recycling from D = 4; the
  adiabatic-continuation refine passes.  ``sweep_ground_states_grown``
  climbs D_start -> D through the su(N) embedding;
  ``multi_start_ground_state`` and ``phase_diagram_sweep`` are built on
  them.
- D = 2 (``sweep_ground_states_fused``): the fused energy objective
  (kernels/energy_fused.py) evaluates the whole batch's energies and
  gradients in one forward and one backward launch per step.
- Large D (``sweep_ground_states_stiefel``): direct Stiefel descent on
  the (2D, D) isometries with recycled environments (plain autograd back
  through the warm power matvecs) and a Newton-Schulz polar retraction,
  all batched PyTorch products, as the JAX package runs it with XLA and
  no Pallas kernel; ``sweep_variance_certificates`` reads each returned
  state's energy variance, and ``grow_isometry`` embeds a D state into 2D.
Every sweep takes the JAX package's ``mesh`` (``parallel/mesh.py``): its
points are split over the mesh's devices, each shard's rows the same pure
function of its starts as without one.  The JAX package's program caches
and scan-length ``chunk`` (TPU compile workarounds) have no counterpart.
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch

from ..config import default_dtypes, resolve_device
from ..core.gates import complex_type
from ..core.linalg import _trace
from ..core.paulis import I2, X, Z
from ..kernels.energy_fused import energy_objective_fused
from .mesh import shard_over_sweep, shards_on_device


def tfim_matrix(g: torch.Tensor) -> torch.Tensor:
    """TFIM 2-site matrix -ZZ + g (XI + IX)/2, real, for a scalar or a
    batch of g (..., 4, 4), on g's device and in g's type."""
    zz = torch.kron(Z, Z).real.to(g)
    xx = (torch.kron(X, I2) + torch.kron(I2, X)).real.to(g)
    return -zz + g[..., None, None] / 2.0 * xx


# ---------------------------------------------------------------------------
# The chart sweeps (qmps_tpu/parallel/sweep.py:28-408, :976-1018)
# ---------------------------------------------------------------------------


def _sweep_ansatz(ansatz: str, D: int):
    """(build, n_params): build maps (..., n_params) parameters to
    (..., 2D, 2D) state unitaries."""
    from ..circuits import ansatze

    if ansatz == "suN":
        return (lambda p: ansatze.full_state_suN(p, D)), (2 * D) ** 2 - 1
    if ansatz == "deep_bw":
        # depth-(n+1) wall of SU(4) KAK bricks: ~depth*n*19 parameters
        # instead of (2D)^2 (circuits/brickwork_deep.py)
        from ..circuits.brickwork_deep import _n_qubits, brick_wall_unitary, n_brick_params

        nq = _n_qubits(D)
        return (lambda p: brick_wall_unitary(p, nq, nq + 1)), n_brick_params(nq, nq + 1)
    if ansatz == "full15":
        return ansatze.shallow_full_state, 15
    builder = ansatze.STATE_ANSATZE[ansatz]
    return (lambda p: builder(D, p)), 2 * 2  # depth-2 default for shallow families


def _recycled_loss_env(build, D: int):
    """(hs, p, r, iters) -> (energies, r_new) with the warm fixed point and
    plain autograd back through its iterations ("unroll": the LU adjoint
    builds a (D^2+1)^2 system per row), shared by the recycled optimizer
    and the refine passes' evaluator, so both read energies from the same
    solve."""
    from ..embed.unitaries import unitary_to_tensor
    from ..optim.riemann import isometry_energy_warm

    def loss_env(hs, p, r, iters):
        A = unitary_to_tensor(build(p))
        V = A.transpose(-3, -2).reshape(A.shape[:-3] + (2 * D, D))  # rows (i, s)
        return isometry_energy_warm(V, hs, D, r, iters, "unroll")

    return loss_env


def _chart_programs(build, D: int, steps: int, lr: float, recycle: bool, recycle_iters: int = 24,
                    final_iters: int = 200):
    """(optimize, evaluate, step_loss) on rows: ``optimize(hs, p0) ->
    (energies, params)`` runs ``steps`` adam steps of every row, the
    energies those of the returned parameters (with ``recycle``, a boosted
    ``final_iters`` evaluation, never the recycled residual);
    ``evaluate(hs, p)`` reads fixed parameters with the optimizer's final
    solve; ``step_loss(hs, p)`` is the summed loss of a first step."""
    from ..algorithms.ground_state import _recycled_adam_core, _recycled_r0
    from ..objectives.energy import energy_exact_env
    from ..optim.minimize import adam_steps, cosine_decay

    loss_env = _recycled_loss_env(build, D)

    def r0(p):
        return _recycled_r0(D, complex_type(p), p.device).expand(p.shape[:-1] + (D, D))

    def step_loss(hs, p):
        if recycle:
            return loss_env(hs, p, r0(p), recycle_iters)[0].sum()
        return energy_exact_env(build(p), hs).sum()

    def optimize(hs, p0):
        if recycle:
            x, _, e = _recycled_adam_core(lambda p, r, it: loss_env(hs, p, r, it), p0, r0(p0), steps, lr,
                                          recycle_iters, final_iters, record=False)
            return e, x
        x, _ = adam_steps(lambda p: step_loss(hs, p), p0, steps, lr, cosine_decay(steps))
        return evaluate(hs, x), x

    @torch.no_grad()
    def evaluate(hs, p):
        if recycle:
            return loss_env(hs, p, r0(p), final_iters)[0]
        return energy_exact_env(build(p), hs)

    return optimize, evaluate, step_loss


def _saved_bytes(loss, p: torch.Tensor) -> int:
    """Bytes autograd saves for the backward of ``loss(p)``, counted with
    saved-tensor hooks (views counted whole: an upper bound)."""
    total = 0

    def pack(t):
        nonlocal total
        total += t.numel() * t.element_size()
        return t

    with torch.enable_grad(), torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        loss(p.detach().requires_grad_())
    return total


def chart_point_chunk(n: int, restarts: int, row_bytes: int, device) -> int:
    """Points a chart-sweep program takes at once: all n on the CPU; on
    CUDA as many as half the card's free memory holds of ``row_bytes``
    (the saved tensors of one row's step) per restart slot, that half
    shared by the shards of a sharded sweep on the card."""
    device = torch.device(device)
    if device.type != "cuda":
        return n
    free, _ = torch.cuda.mem_get_info(device)
    return max(1, min(n, int(free // 2 // shards_on_device() // max(1, restarts * row_bytes))))


def _sweep_from_starts(gs: torch.Tensor, p0s: torch.Tensor, D: int, ansatz: str, steps: int, lr: float,
                       refine_passes: int, recycle: bool, point_chunk: int | None, jitter, mesh=None):
    """The body of ``sweep_ground_states`` from given starts p0s (n,
    restarts, n_params), on gs's device and in its type; ``jitter(k,
    shift, shape)`` gives refine pass k's noise for the slots past 0 (the
    JAX package folds 1000 + 2k + (shift > 0) into its key).  With a
    ``mesh`` the optimizations and evaluations run sharded over its
    devices, each shard in point chunks of its own; the refine passes'
    neighbours and jitter are taken on the whole batch.  Returns (energies
    (n,), params (n, n_params))."""
    build, _ = _sweep_ansatz(ansatz, D)
    optimize, evaluate, step_loss = _chart_programs(build, D, steps, lr, recycle)
    n, restarts, k = p0s.shape
    hs_all = tfim_matrix(gs)
    if point_chunk is None:
        row_bytes = _saved_bytes(lambda p: step_loss(hs_all[:1], p), p0s[:1, 0])

    def chunk_of(hs):
        """The point chunk of a block of points on hs's device."""
        return point_chunk or chart_point_chunk(hs.shape[0], restarts, row_bytes, hs.device)

    def optimize_block(hs_b, p0):
        """Every chunk's restarts optimized, the best kept per point."""
        m_all, c = hs_b.shape[0], chunk_of(hs_b)
        es, ps = [], []
        for i in range(0, m_all, c):
            m = min(c, m_all - i)
            hs = hs_b[i:i + m, None].expand(m, restarts, 4, 4).reshape(-1, 4, 4)
            e, p = optimize(hs, p0[i:i + m].reshape(-1, k))
            e = e.reshape(m, restarts)
            j = torch.argmin(e, dim=1)
            rows = torch.arange(m, device=e.device)
            es.append(e[rows, j])
            ps.append(p.reshape(m, restarts, k)[rows, j])
        return torch.cat(es), torch.cat(ps)

    def evaluate_block(hs_b, p):
        c = chunk_of(hs_b)
        return torch.cat([evaluate(hs_b[i:i + c], p[i:i + c]) for i in range(0, hs_b.shape[0], c)])

    run = shard_over_sweep(optimize_block, mesh)
    run_eval = shard_over_sweep(evaluate_block, mesh)
    es, ps = run(hs_all, p0s)
    for kp in range(refine_passes):
        for shift in (1, -1):
            p_nb = torch.roll(ps, shift, 0)
            # (a) the verbatim neighbour: the ground state is continuous in
            # g, so a good neighbour's parameters cost O(dg^2) here; this
            # hop heals an attractive bad basin that (b) can fall back into
            e_nb = run_eval(hs_all, p_nb)
            better = e_nb < es
            es = torch.where(better, e_nb, es)
            ps = torch.where(better[:, None], p_nb, ps)
            # (b) the polished re-optimization from the neighbour's basin;
            # slot 0 exact, the other slots jittered
            p0n = p_nb[:, None, :].expand(n, restarts, k)
            if restarts > 1:
                noise = jitter(kp, shift, p0n.shape).to(p0n)
                noise[:, 0] = 0.0
                p0n = p0n + noise
            e2, p2 = run(hs_all, p0n)
            better = e2 < es
            es = torch.where(better, e2, es)
            ps = torch.where(better[:, None], p2, ps)
    return es, ps


def sweep_ground_states(gs, D: int = 2, ansatz: str = "suN", steps: int = 300, lr: float = 0.05,
                        generator: torch.Generator | None = None, mesh=None, restarts: int = 1,
                        refine_passes: int = 0, recycle: bool | None = None, point_chunk: int | None = None,
                        warm_params=None, device=None):
    """Ground-state energies of the TFIM for a batch of couplings g: adam
    over the parameters of ``ansatz`` ("suN" (2D)^2 - 1, "deep_bw" the
    depth-(n+1) brick wall, "full15" 15, a shallow circuit of
    ``circuits.ansatze.STATE_ANSATZE`` 4), every point x restart one row
    of one batch, the best restart kept per point.

    ``recycle`` (None: on for D >= 4): the environment rides the steps,
    refined by 24 warm power matvecs a step, with plain autograd back
    through them; the reported energy is a 200-iteration evaluation of the
    returned parameters.  Off, every step solves the environment cold
    (``objectives.energy.energy_exact_env``).

    ``refine_passes`` adiabatic-continuation passes after the random-start
    sweep: in both directions, each point is (a) evaluated verbatim at its
    neighbour's parameters and (b) re-optimized from them (slot 0 exact,
    the other slots jittered by 0.05 normals); the elementwise best is
    kept.  A point stuck in a bad basin inherits a neighbour's good one.

    ``warm_params`` (n, n_params) replaces slot 0's start (the bond-growth
    hook); the other slots stay random.  ``generator`` (a CPU generator,
    seed 0 if None) draws the starts, normal * 0.5, and the jitter.
    ``point_chunk`` bounds the points one program takes, for memory: None
    is ``chart_point_chunk`` (all points on the CPU; on CUDA half the free
    memory over one row's saved tensors); the chunks do not change the
    result.  ``mesh`` (``parallel.mesh``) shards the points over its
    devices, the chunks applying per shard; the starts and jitter are
    drawn on the whole batch first, so the shards do not change the
    result either.  ``device`` defaults to gs's for a tensor, else to the card;
    the precision follows a tensor gs (float32 -> complex64), else the
    device (``config.default_dtypes``).

    Returns (energies (n,), params (n, n_params)).
    """
    device = resolve_device(device, gs)
    _, rdtype = default_dtypes(device, gs if isinstance(gs, torch.Tensor) else None)
    gs = torch.as_tensor(gs).to(device, rdtype)
    n = gs.shape[0]
    _, n_params = _sweep_ansatz(ansatz, D)
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    p0s = torch.randn((n, restarts, n_params), generator=generator, dtype=torch.float64) * 0.5
    if warm_params is not None:
        warm_params = torch.as_tensor(warm_params)
        if tuple(warm_params.shape) != (n, n_params):
            raise ValueError(f"warm_params must be {(n, n_params)}, got {tuple(warm_params.shape)}")
        p0s[:, 0] = warm_params.to(p0s)

    def jitter(k, shift, shape):
        return 0.05 * torch.randn(shape, generator=generator, dtype=torch.float64)

    return _sweep_from_starts(gs, p0s.to(device, rdtype), D, ansatz, steps, lr, refine_passes,
                              D >= 4 if recycle is None else recycle, point_chunk, jitter, mesh)


def _grown_from_starts(gs: torch.Tensor, D: int, steps: int, lr: float, restarts: int, refine_passes: int,
                       D_start: int, stage_steps: int | None, eps: float, point_chunk: int | None,
                       return_stages: bool, starts, jitter, mesh=None):
    """The body of ``sweep_ground_states_grown``: ``starts(i, shape)`` gives
    rung i's random starts (before slot 0 takes the warm start) and
    ``jitter(i)`` rung i's refine-pass noise function."""
    from ..core.lie import grow_su_params

    if D_start < 2 or D & (D - 1) or D_start & (D_start - 1) or D < D_start:
        raise ValueError("D and D_start must be powers of two with D >= D_start >= 2")
    if stage_steps is not None and stage_steps < 1:
        raise ValueError(f"stage_steps must be >= 1, got {stage_steps}")
    ladder = [D_start]
    while ladder[-1] < D:
        ladder.append(2 * ladder[-1])
    stages = {}
    warm = None
    n = gs.shape[0]
    for i, d in enumerate(ladder):
        final = d == D
        p0s = starts(i, (n, restarts, (2 * d) ** 2 - 1)).to(gs.device, gs.dtype)
        if warm is not None:
            p0s[:, 0] = warm
        es, ps = _sweep_from_starts(gs, p0s, d, "suN", steps if final or stage_steps is None else stage_steps,
                                    lr, refine_passes if final else 0, d >= 4, point_chunk, jitter(i), mesh)
        if return_stages:
            stages[d] = (es, ps)
        if not final:
            # the exact linear su(N) -> su(2N) embedding, on the host
            warm = torch.from_numpy(grow_su_params(ps.double().cpu().numpy(), eps)).to(gs.device, gs.dtype)
    return (es, ps, stages) if return_stages else (es, ps)


def sweep_ground_states_grown(gs, D: int, steps: int = 300, lr: float = 0.05,
                              generator: torch.Generator | None = None, mesh=None, restarts: int = 1,
                              refine_passes: int = 0,
                              D_start: int = 2, stage_steps: int | None = None, eps: float = 4e-2,
                              point_chunk: int | None = None, return_stages: bool = False, device=None):
    """Bond-growth continuation sweep ("suN" only): optimize the whole
    grid at D_start, embed every point's su(2D') parameters into su(4D')
    (``core.lie.grow_su_params``, exact up to the eps nudge) as slot 0's
    start of the next rung, and repeat up to D.  Every point enters the
    larger manifold inside its smaller-D basin, which heals the attractive
    bad basins random starts leave and refine passes cannot reach.

    ``stage_steps`` (None: ``steps``) bounds the intermediate rungs;
    refine passes run at the final D only.  Each rung draws its starts
    from a generator of its own, seeded from ``generator`` (a CPU
    generator, seed 0 if None).  ``point_chunk`` and ``mesh`` apply to
    every rung;
    ``device`` and precision as ``sweep_ground_states``.  Returns
    (energies, params) at D; with ``return_stages``, also {D': (energies,
    params)} of every rung.
    """
    device = resolve_device(device, gs)
    _, rdtype = default_dtypes(device, gs if isinstance(gs, torch.Tensor) else None)
    gs = torch.as_tensor(gs).to(device, rdtype)
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    seed = int(torch.randint(0, 2**62, (1,), generator=generator))
    gens = {}

    def rung(i):
        return gens.setdefault(i, torch.Generator().manual_seed(_slot_seed(seed, 2, i)))

    def starts(i, shape):
        return torch.randn(shape, generator=rung(i), dtype=torch.float64) * 0.5

    def jitter(i):
        return lambda k, shift, shape: 0.05 * torch.randn(shape, generator=rung(i), dtype=torch.float64)

    return _grown_from_starts(gs, D, steps, lr, restarts, refine_passes, D_start, stage_steps, eps, point_chunk,
                              return_stages, starts, jitter, mesh)


def multi_start_ground_state(g: float, D: int = 2, ansatz: str = "suN", n_starts: int = 64, steps: int = 300,
                             lr: float = 0.05, generator: torch.Generator | None = None, device=None):
    """``n_starts`` random initializations at one coupling g, optimized in
    one batch (``sweep_ground_states``), the best kept: the reference's
    retry-until-monotone done in parallel.  ``device`` as
    ``config.resolve_device`` (the card unless asked).  Returns (energy,
    params)."""
    device = resolve_device(device)
    _, rdtype = default_dtypes(device)
    gs = torch.full((n_starts,), float(g), dtype=rdtype, device=device)
    es, params = sweep_ground_states(gs, D=D, ansatz=ansatz, steps=steps, lr=lr, generator=generator)
    i = torch.argmin(es)
    return es[i], params[i]


def phase_diagram_sweep(gs, Ds=(2,), ansatz: str = "suN", steps: int = 300,
                        generator: torch.Generator | None = None, mesh=None, device=None) -> torch.Tensor:
    """(len(Ds), len(gs)) energy table: ``sweep_ground_states`` at each D
    (ragged shapes, one batch each, sharded over ``mesh``), each D's starts
    from a generator of its own seeded from ``generator`` (a CPU generator,
    seed 0 if None)."""
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    seed = int(torch.randint(0, 2**62, (1,), generator=generator))
    return torch.stack([
        sweep_ground_states(gs, D=D, ansatz=ansatz, steps=steps,
                            generator=torch.Generator().manual_seed(_slot_seed(seed, 3, i)), mesh=mesh,
                            device=device)[0]
        for i, D in enumerate(Ds)
    ])


def sweep_ground_states_fused(
    gs,
    steps: int = 300,
    lr: float = 0.1,
    momentum: float = 0.9,
    restarts: int = 1,
    generator: torch.Generator | None = None,
    iters: int = 48,
    mesh=None,
    device=None,
):
    """The D = 2 phase-diagram sweep with the fused energy objective:
    heavy-ball Riemannian descent on the (4, 2) MPS isometry of every
    (point, restart) — tangent projection, retraction by the closed-form
    2x2 polar factor — for ``steps`` steps, then the best of ``restarts``
    per point.

    ``gs`` (n,) couplings; ``generator`` draws the starting isometries (a
    CPU ``torch.Generator``, seed 0 if None, on the whole batch); ``mesh``
    shards the steps and the final pick over its devices (n must divide);
    ``device`` defaults to gs's for a tensor, else to the card
    (``config.resolve_device``).  On the CPU the sweep runs in complex128
    with the plain objective, on CUDA in complex64 with the kernels.

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

    return _fused_sweep_from(gs, xre, xim, steps, lr, momentum, restarts, iters, mesh)


def _fused_sweep_from(gs, xre, xim, steps, lr, momentum, restarts, iters, mesh=None):
    """sweep_ground_states_fused's body from given starts: ``xre``, ``xim``
    (n * restarts, 4, 2) normals on gs's device in its type.  The steps and
    the final pick are sharded over ``mesh``."""
    init, advance, finish = _fused_sweep_programs(lr, momentum, restarts, iters)
    hs, V, M = init(gs, xre, xim)
    V, M = shard_over_sweep(advance, mesh)(V, M, hs, steps)
    return shard_over_sweep(finish, mesh)(V, hs)


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


# ---------------------------------------------------------------------------
# Large D: the Stiefel sweep (qmps_tpu/parallel/sweep.py:589-975)
# ---------------------------------------------------------------------------

#: complex (D, D) tensors autograd keeps for each warm iteration of a point
#: in the descent step, counted with saved-tensor hooks on the CPU
#: (tests/test_torch_stiefel_sweep.py::test_point_chunk_rule_counts_the_saved_tensors)
SAVED_PER_ITER = 4


def stiefel_point_chunk(n: int, D: int, restarts: int, recycle_iters: int, dtype, device) -> int:
    """Points a descent program takes at once: all n on the CPU; on CUDA
    as many as half the card's free memory holds of the unroll stack,
    recycle_iters x SAVED_PER_ITER complex (D, D) tensors per restart
    slot (a D = 32 point with 96 iterations at complex64: 3.1 MB), that
    half shared by the shards of a sharded sweep on the card."""
    device = torch.device(device)
    if device.type != "cuda":
        return n
    free, _ = torch.cuda.mem_get_info(device)
    per_point = restarts * recycle_iters * SAVED_PER_ITER * D * D * torch.empty(0, dtype=dtype).element_size()
    return max(1, min(n, int(free // 2 // shards_on_device() // per_point)))


def _polar_ns(W: torch.Tensor, iters: int = 10) -> torch.Tensor:
    """Batched polar factor of (..., n, m) tall matrices by the coupled
    Newton-Schulz inverse-square-root iteration: batched m x m products
    only.  W is near-isometric along the descent (W^dag W ~ I); the trace
    scaling centres the spectrum at 1 and a relative jitter (1e-6 in
    float32, 1e-12 in float64) floors W^dag W away from singularity."""
    m = W.shape[-1]
    eye = torch.eye(m, dtype=W.dtype, device=W.device)
    H = W.mH @ W
    c = _trace(H).real / m
    c = c.clamp(min=torch.finfo(c.dtype).tiny)
    jit_eps = 1e-6 if torch.finfo(c.dtype).eps > 1e-10 else 1e-12
    Y = H / c[..., None, None] + jit_eps * eye
    Z = eye.expand(Y.shape)
    for _ in range(iters):
        T = 1.5 * eye - 0.5 * (Z @ Y)
        Y = Y @ T
        Z = T @ Z
    return W @ Z / torch.sqrt(c)[..., None, None]


_TIERS = (None, "highest", "high", "default")


@contextlib.contextmanager
def _matmul_tier(precision: str | None):
    """The JAX package's matmul-precision tiers, as cuBLAS has them:
    "default" (one bf16 pass on the TPU) -> one-pass TF32; "high" (three
    bf16 passes, near float32: cuBLAS has no counterpart) and "highest" ->
    full float32, the package's pin.  Restores the float32 matmul
    precision and ``allow_tf32`` on exit."""
    if precision not in _TIERS:
        raise ValueError(f"precision must be one of {_TIERS}, not {precision!r}")
    if precision != "default":
        yield
        return
    saved = torch.get_float32_matmul_precision(), torch.backends.cuda.matmul.allow_tf32
    torch.set_float32_matmul_precision("high")
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(saved[0])
        torch.backends.cuda.matmul.allow_tf32 = saved[1]


def _stiefel_sweep_programs(D: int, lr: float, momentum: float, restarts: int, recycle_iters: int,
                            final_iters: int):
    """(init, advance, finish) of ``sweep_ground_states_stiefel`` on plain
    tensors, so a caller can start them from any state (the JAX package's
    included).  ``advance`` takes a precision tier for its steps;
    ``init`` and ``finish`` run at full float32."""
    from ..optim.riemann import _project_tangent, isometry_energy_warm

    def loss(V, r, hs, iters):
        return isometry_energy_warm(V, hs, D, r, iters, "unroll")

    def init(gs, xre, xim, warm=None):
        """(hs (B, 4, 4) real, V0 (B, 2D, D), M0 = 0, r0 = I/sqrt(D)), B =
        n restarts, slot 0 of each point from ``warm`` where given."""
        n = gs.shape[0]
        hs = tfim_matrix(gs.to(xre))[:, None].expand(n, restarts, 4, 4).reshape(-1, 4, 4)
        V0, _ = torch.linalg.qr(torch.complex(xre, xim))
        if warm is not None:
            V0 = V0.reshape(n, restarts, 2 * D, D)
            V0 = torch.cat([warm.to(V0)[:, None], V0[:, 1:]], 1).reshape(-1, 2 * D, D)
        r0 = torch.eye(D, dtype=V0.dtype, device=V0.device) / D ** 0.5
        return hs, V0, torch.zeros_like(V0), r0.expand(V0.shape[0], D, D)

    def advance(V, M, r, hs, length, precision=None):
        """``length`` heavy-ball steps on (V, M, r) at ``precision``."""
        with _matmul_tier(precision):
            for _ in range(length):
                with torch.enable_grad():
                    Vg = V.detach().requires_grad_()
                    es, r_new = loss(Vg, r, hs, recycle_iters)
                    # points are independent: the gradient of the sum is
                    # every point's gradient, and torch's .grad is already
                    # conj(jax.grad), so sweep.py:696's G.conj() goes
                    (G,) = torch.autograd.grad(es.sum(), Vg)
                with torch.no_grad():
                    M = momentum * M + _project_tangent(V, G)
                    V = _polar_ns(V - lr * M)
                    M = _project_tangent(V, M)
                r = r_new.detach()
        return V, M, r

    @torch.no_grad()
    def finish(V, r, hs):
        """Best of the restarts after a ``final_iters`` refinement:
        (energies (n,), As (n, 2, D, D), rs (n, D, D))."""
        es, r = loss(V, r, hs, final_iters)
        er = es.reshape(-1, restarts)
        i = torch.argmin(er, dim=1)
        rows = torch.arange(er.shape[0], device=V.device)
        Vb = V.reshape(-1, restarts, 2 * D, D)[rows, i]
        rb = r.reshape(-1, restarts, D, D)[rows, i]
        return er.min(dim=1).values, Vb.reshape(-1, D, 2, D).transpose(1, 2).contiguous(), rb

    return init, advance, finish


def _slot_seed(seed: int, branch: int, slot: int) -> int:
    return int(np.random.SeedSequence([seed, branch, slot]).generate_state(1, np.uint64)[0])


def _nested_restart_normals(seed: int, restarts: int, shape):
    """(re, im) float64 standard normals of shape (shape[0], restarts,
    *shape[1:]) on the CPU, slot s drawn from a generator of its own,
    seeded by (seed, branch, s): slot s's draw depends on (seed, s) only,
    never on ``restarts``, so restart sets nest and best-of-(k+1) never
    loses to best-of-k (the counterpart of the JAX package's fold_in
    keys; the streams differ)."""
    def draw(branch, s):
        g = torch.Generator().manual_seed(_slot_seed(seed, branch, s))
        return torch.randn(shape, generator=g, dtype=torch.float64)

    return tuple(torch.stack([draw(b, s) for s in range(restarts)], 1) for b in (0, 1))


def sweep_ground_states_stiefel(gs, D: int, steps: int = 300, lr: float = 0.08, momentum: float = 0.9,
                                restarts: int = 1, generator: torch.Generator | None = None,
                                recycle_iters: int | None = None, final_iters: int = 200,
                                point_chunk: int | None = None, mesh=None, warm_V=None,
                                precision: str | None = None, polish_steps: int = 0, device=None):
    """BASELINE config 4 at large D: the phase-diagram sweep by direct
    Stiefel descent on the (2D, D) MPS isometry.  A step of the whole
    batch is one backward of the warm-environment energy (batched power
    matvecs, plain autograd back through them), a tangent projection and
    a Newton-Schulz polar retraction.

    ``gs`` (n,) couplings; ``generator`` (a CPU ``torch.Generator``, seed
    0 if None) gives one seed, from which each restart slot draws its
    starts (``_nested_restart_normals``: slot s's start depends on the
    seed and s only, and not on ``point_chunk``); ``warm_V`` (n, 2D, D)
    seeds slot 0 (``grow_isometry``).  ``device`` defaults to gs's for a
    tensor, else to the card; the working precision follows a tensor gs
    (float32 -> complex64), else the device (``config.default_dtypes``).

    ``recycle_iters`` (None: 24 below D = 16, 96 from D = 16) is a
    correctness knob: the descent follows the iters-refined energy, and an
    environment that cannot keep up with the state's transfer gap lets it
    exploit the unconverged readout (energies below the ground state).

    ``precision`` / ``polish_steps``: the first ``steps - polish_steps``
    steps run at ``precision`` (``_matmul_tier``: "default" is one-pass
    TF32 on the card; "high", "highest" and None full float32), the last
    ``polish_steps`` (clamped to [0, steps]) and the final
    ``final_iters`` readout always at full float32.

    ``point_chunk`` bounds the points a descent program takes at once,
    for memory: None is ``stiefel_point_chunk`` (all points on the CPU;
    on CUDA half the free memory over the unroll stack's bytes).  Each
    chunk runs the whole descent; the result does not depend on it.
    ``mesh`` shards the points over its devices, each shard in chunks of
    its own; the starts are drawn on the whole batch first.

    Returns (energies (n,), As (n, 2, D, D) left-canonical, rs (n, D, D)
    the converged environments), the best of ``restarts`` per point.
    """
    device = resolve_device(device, gs)
    _, rdtype = default_dtypes(device, gs if isinstance(gs, torch.Tensor) else None)
    gs = torch.as_tensor(gs).to(device, rdtype)
    n = gs.shape[0]
    if recycle_iters is None:
        recycle_iters = 24 if D < 16 else 96
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    seed = int(torch.randint(0, 2**62, (1,), generator=generator))
    xre, xim = _nested_restart_normals(seed, restarts, (n, 2 * D, D))
    polish = min(max(int(polish_steps), 0), steps) if precision else 0
    warm_V = None if warm_V is None else torch.as_tensor(warm_V)
    return _stiefel_sweep_from(gs, xre, xim, warm_V, D, steps, lr, momentum, restarts, recycle_iters, final_iters,
                               point_chunk, mesh, precision, polish)


def _stiefel_sweep_from(gs, xre, xim, warm_V, D, steps, lr, momentum, restarts, recycle_iters, final_iters,
                        point_chunk=None, mesh=None, precision=None, polish=0):
    """sweep_ground_states_stiefel's body from given starts: ``xre``,
    ``xim`` (n, restarts, 2D, D) float64 normals on the CPU, ``warm_V``
    (n, 2D, D) or None.  The points are sharded over ``mesh``, each shard
    in chunks of its own."""
    cdtype, rdtype = default_dtypes(gs.device, gs)
    init, advance, finish = _stiefel_sweep_programs(D, lr, momentum, restarts, recycle_iters, final_iters)

    def descend(gs_b, xre_b, xim_b, warm_b):
        """The descent of a block of points, in chunks, on gs_b's device."""
        nb, dev = gs_b.shape[0], gs_b.device
        chunk = point_chunk or stiefel_point_chunk(nb, D, restarts, recycle_iters, cdtype, dev)
        outs = []
        for i in range(0, nb, chunk):
            sl = slice(i, i + chunk)
            m = gs_b[sl].shape[0]
            warm = None if warm_b is None else warm_b[sl].to(dev, cdtype)
            hs, V, M, r = init(gs_b[sl], *(x[sl].reshape(m * restarts, 2 * D, D).to(dev, rdtype)
                                           for x in (xre_b, xim_b)), warm)
            V, M, r = advance(V, M, r, hs, steps - polish, precision)
            V, M, r = advance(V, M, r, hs, polish)
            outs.append(finish(V, r, hs))
        return tuple(torch.cat([o[j] for o in outs]) for j in range(3))

    return shard_over_sweep(descend, mesh)(gs, xre, xim, warm_V)


@torch.no_grad()
def sweep_variance_certificates(gs, As, rs, env_iters: int = 40, k: int = 48, restarts: int = 4,
                                point_chunk: int | None = None, device=None):
    """Per-point energy-variance certificates of sweep outputs: sigma^2_i
    = (<H^2> - <H>^2)/N of point i's returned state, H = sum_n h(g_i).
    Oracle-free: sigma^2 = 0 iff the state is an exact eigenstate, and
    |E - E_0| <= sigma^2 / gap, so a point stuck in a bad basin or short
    of convergence is flagged by its own variance.

    As (n, d, D, D) left-canonical tensors and rs (n, D, D) environments,
    as ``sweep_ground_states_stiefel`` returns them; the environments are
    refined by ``env_iters`` power matvecs (hermitized, unit Frobenius,
    then unit trace), then every certificate runs the GMRES tail of
    ``mps.tdvp.energy_variance_density`` (k, restarts), all points in one
    batch, or ``point_chunk`` at a time.  Returns (n,) real variances.
    """
    from ..mps.tdvp import energy_variance_density

    device = resolve_device(device, As, rs, gs)
    As = torch.as_tensor(As).to(device)
    rs = torch.as_tensor(rs).to(device, As.dtype)
    gs = torch.as_tensor(gs).to(device, As.real.dtype)
    n = gs.shape[0]
    Ac = As.conj().resolve_conj()

    def one(sl):
        A, r = As[sl], rs[sl]
        for _ in range(env_iters):
            r = torch.einsum("...sai,...ij,...sbj->...ab", A, r, Ac[sl])
            r = (r + r.mH) / 2
            r = r / torch.linalg.matrix_norm(r)[..., None, None]
        r = r / _trace(r)[..., None, None]
        return energy_variance_density(A, r, tfim_matrix(gs[sl]).to(A.dtype), env_solver="gmres", k=k,
                                       restarts=restarts)

    step = point_chunk or n
    return torch.cat([one(slice(i, i + step)) for i in range(0, n, step)])


def grow_isometry(A, eps: float = 1e-3, generator: torch.Generator | None = None) -> torch.Tensor:
    """Bond-growth warm start in tensor space: embed converged (n, d, D, D)
    (or one (d, D, D)) left-canonical tensors into (d, 2D, 2D) as the
    direct sum with an eps-scaled real normal block (drawn from
    ``generator``, a CPU generator, seed 17 if None), returned as the
    (2dD, 2D) isometries of ``sweep_ground_states_stiefel``'s ``warm_V``
    after a 14-step Newton-Schulz polar.  The embedded state reproduces
    the D state's energy up to O(eps)."""
    A = torch.as_tensor(A)
    batched = A.ndim == 4
    if not batched:
        A = A[None]
    B, d, D, _ = A.shape
    if generator is None:
        generator = torch.Generator().manual_seed(17)
    noise = eps * torch.randn((B, d, 2 * D, 2 * D), generator=generator, dtype=torch.float64)
    A2 = torch.nn.functional.pad(A, (0, D, 0, D)) + noise.to(A.device, A.real.dtype)
    V = _polar_ns(A2.transpose(1, 2).reshape(B, 2 * D * d, 2 * D), iters=14)
    return V if batched else V[0]
