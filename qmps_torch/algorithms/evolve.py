"""Real-time TDVP quenches (counterpart of ``qmps_tpu.algorithms.evolve``).

Per time step, the candidate state's parameters maximize the per-site
overlap density with W|psi(t)> (qmps/new_time_evolve.py:252-302), by an
adam loop warm-started from the current parameters.

- ``MPSTimeEvolve``: one trajectory, with an atomic checkpoint every
  ``checkpoint_every`` steps and resume from it, a per-step record of
  Pauli expectation values and the overlap with the initial state, and an
  optional ``ConvergenceRecord`` log; the dense ``tdvp_objective``.
- ``compile_state_to_ansatz``: the ansatz parameters of a given state.
- ``loschmidt_echo_run``: the reference's single-trajectory quench
  pipeline (scripts/loschmidt.py:335-382).
- ``batched_quench_sweep``: a family of quench trajectories in lockstep,
  with both engines.
- ``NoisyMPSTimeEvolve``: the stepper on the depolarizing-noise objective
  (scripts/loschmidt.py:241-277); ``batched_noise_sweep``: the
  reference's production noise study, every noise level in lockstep as
  one batch; ``noisy_loschmidt_echo_run``: the same study one stepper a
  level (scripts/loschmidt.py:335-382).

The two batched sweeps take the JAX package's ``mesh``
(``parallel/mesh.py``): the trajectories are split over its devices.  Its
``chunk`` and compiled-step cache are TPU compile workarounds and have no
counterpart here.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Callable

import numpy as np
import scipy.linalg
import torch

from ..circuits import ansatze
from ..config import default_dtypes, resolve_device
from ..core.gates import complex_type
from ..core.paulis import X, Y, Z
from ..embed.unitaries import unitary_to_tensor
from ..ham.hamiltonian import as_host_matrix, tfim
from ..mps.imps import iMPS
from ..mps.transfer import right_fixed_point
from ..objectives.noise import noisy_tdvp_objective
from ..objectives.overlap import tdvp_objective, tdvp_objective_pallas
from ..optim.minimize import adam_steps
from ..parallel.mesh import shard_over_sweep
from ..parallel.sweep import tfim_matrix
from ..utils.checkpoint import load_checkpoint, save_checkpoint
from .ground_state import find_ground_state


@dataclasses.dataclass
class EvolveRecord:
    params: torch.Tensor  # (steps + 1, n_params)
    loschmidt: torch.Tensor  # (steps,) |<psi_0|psi_t>|^2 per site
    evs: torch.Tensor  # (steps, len(record_ops)) expectation values
    errors: torch.Tensor  # (steps,) the objective at each step's returned params


def _warm_started_minimize(loss, p: torch.Tensor, inner_steps: int, lr: float) -> torch.Tensor:
    """``inner_steps`` constant-rate adam steps on ``loss`` from p, with a
    fresh optimizer state (re-initialised at every outer step)."""
    return adam_steps(loss, p, inner_steps, lr)[0]


class MPSTimeEvolve:
    """TDVP stepper over a parametrized circuit-MPS manifold.

    ``gate``: params -> state unitary (default the 15-param SU(4) circuit
    "full15", qmps/new_time_evolve.py:187-188).  W = expm(-i h
    trotter_factor dt) on the host in complex128: the reference's 2-site
    gate advances the 2-site unit cell by dt (scripts/loschmidt.py:341).
    ``device``: where ``evolve`` runs; None follows ``config.resolve_device``
    (the parameters' device for a tensor, else the card).  The precision
    is the parameters': float32 runs the complex64 objective.
    """

    def __init__(self, H, dt: float, gate: Callable | None = None, inner_steps: int = 80,
                 lr: float = 3e-2, trotter_factor: float = 2.0, device=None):
        self.h = as_host_matrix(H)
        self.dt = dt
        self.W = scipy.linalg.expm(-1j * np.asarray(self.h) * trotter_factor * dt)
        self.gate = ansatze.shallow_full_state if gate is None else gate
        self.inner_steps = inner_steps
        self.lr = lr
        self.device = device

    def tensor(self, params: torch.Tensor) -> torch.Tensor:
        return unitary_to_tensor(self.gate(params))

    def objective(self, A: torch.Tensor, B: torch.Tensor, W: torch.Tensor) -> torch.Tensor:
        """The inner objective of a step, candidate B against W|A>: the
        dense TDVP objective (the noisy stepper overrides it)."""
        return tdvp_objective(A, B, W)

    def step(self, params: torch.Tensor):
        """One TDVP step from ``params``: ``inner_steps`` adam steps of the
        objective at a constant rate, from a fresh optimizer state.
        Returns (new params, the objective AT the new params): the last
        pre-update value would belong to the penultimate iterate."""
        W = torch.from_numpy(self.W).to(params.device, complex_type(params))
        with torch.no_grad():
            A = self.tensor(params)

        def loss(p):
            return self.objective(A, self.tensor(p), W)

        p = _warm_started_minimize(loss, params, self.inner_steps, self.lr)
        with torch.no_grad():
            return p, loss(p)

    def evolve(self, params0, n_steps: int, record_ops=(X, Y, Z), checkpoint_path: str | None = None,
               checkpoint_every: int = 25, log=None) -> EvolveRecord:
        """Run ``n_steps`` TDVP steps from ``params0``.

        ``checkpoint_path``: the whole restart state (trajectory,
        observables, step counter) is saved there atomically every
        ``checkpoint_every`` steps and at the end, and a later call with
        the same path resumes from the last saved step (the reference could
        only np.save trajectories, qmps/new_time_evolve.py:294).  ``log``:
        a ``utils.logging.ConvergenceRecord`` that collects each step's
        objective with its wall-clock time.  Step first, then record:
        loschmidt[k] is the state at t = (k + 1) dt."""
        device = resolve_device(self.device, params0)
        _, rdtype = default_dtypes(device, like=params0)
        ops = list(record_ops)
        ps = [torch.as_tensor(params0).to(device, rdtype)]
        les, evss, errs = [], [], []
        if checkpoint_path and os.path.exists(checkpoint_path):
            state = load_checkpoint(checkpoint_path)
            ps, les, evss, errs = (list(state[k].to(device, rdtype)) for k in ("ps", "les", "evss", "errs"))
        params = ps[-1]
        with torch.no_grad():
            psi0 = iMPS([self.tensor(ps[0])])

        def stacked(xs, empty_shape):
            return torch.stack(xs).cpu().numpy() if xs else np.zeros(empty_shape)

        def save(step_done):
            save_checkpoint(checkpoint_path, {
                "step": np.int64(step_done), "ps": stacked(ps, (0,)), "les": stacked(les, (0,)),
                "evss": stacked(evss, (0, len(ops))), "errs": stacked(errs, (0,)),
            })

        for k in range(len(les), n_steps):
            params, err = self.step(params)
            ps.append(params)
            errs.append(err)
            with torch.no_grad():
                psi_t = iMPS([self.tensor(params)])
                evss.append(psi_t.Es(ops))
                les.append(psi_t.overlap(psi0))
            if log is not None:
                log.append(float(err))
            if checkpoint_path and ((k + 1) % checkpoint_every == 0 or k + 1 == n_steps):
                save(k + 1)
        return EvolveRecord(params=torch.stack(ps), loschmidt=torch.stack(les), evs=torch.stack(evss),
                            errors=torch.stack(errs))


def compile_state_to_ansatz(A, gate: Callable | None = None, n_params: int = 15, steps: int = 800,
                            lr: float = 5e-2, generator: torch.Generator | None = None, device=None):
    """Ansatz parameters whose state overlaps a target uMPS tensor A
    (d, D, D) most (the reference's compilation of the initial state into
    the gate, scripts/loschmidt.py:356-359, with gradients): ``steps`` adam
    steps of the TDVP objective at W = I from normals * 0.1 drawn from
    ``generator`` (a CPU generator, seed 0 if None).  ``device`` follows
    ``config.resolve_device``; the precision is A's for a tensor, else the
    device's."""
    gate = ansatze.shallow_full_state if gate is None else gate
    device = resolve_device(device, A)
    cdtype, rdtype = default_dtypes(device, like=A)
    A = torch.as_tensor(A).to(device, cdtype)
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    p0 = torch.randn(n_params, generator=generator, dtype=torch.float64).to(device, rdtype) * 0.1
    eye = torch.eye(4, dtype=cdtype, device=device)
    return adam_steps(lambda p: tdvp_objective(A, unitary_to_tensor(gate(p)), eye), p0, steps, lr)[0]


def loschmidt_echo_run(g0: float, g1: float, t_max: float, n_steps: int, gate: Callable | None = None,
                       inner_steps: int = 120, gs_steps: int = 400, generator: torch.Generator | None = None,
                       device=None):
    """The full quench pipeline (scripts/loschmidt.py:335-382): the ground
    state of tfim(g0) (L-BFGS, ``gs_steps``, the full15 ansatz, initial
    guess from ``generator``), evolved under tfim(g1) by ``MPSTimeEvolve``
    for ``n_steps`` steps of dt = t_max / n_steps.  ``device`` follows
    ``config.resolve_device`` (the card unless asked): float32 on CUDA,
    float64 on the CPU.  Returns (times, the rate -log(overlap density),
    EvolveRecord)."""
    device = resolve_device(device)
    gs = find_ground_state(tfim(g0), D=2, ansatz="full15", method="lbfgs", steps=gs_steps,
                           generator=generator, device=device)
    dt = t_max / n_steps
    rec = MPSTimeEvolve(tfim(g1), dt, gate=gate, inner_steps=inner_steps, device=device).evolve(gs.params, n_steps)
    times = torch.arange(1, n_steps + 1, dtype=rec.loschmidt.dtype, device=device) * dt
    return times, -torch.log(rec.loschmidt), rec


def batched_quench_sweep(
    g0: float,
    g1s,
    t_max: float,
    n_steps: int,
    inner_steps: int = 80,
    gs_steps: int = 300,
    lr: float = 3e-2,
    generator: torch.Generator | None = None,
    mesh=None,
    params0=None,
    engine: str = "dense",
    pallas_iters: int = 48,
    device=None,
):
    """TFIM quench trajectories g0 -> g1 for every g1 of ``g1s``, advanced
    in lockstep as one batch: per outer step of dt = t_max / n_steps,
    ``inner_steps`` adam steps of the summed TDVP objective over the whole
    family (W = expm(-i h(g1) 2 dt), the full15 ansatz), then the overlap
    density |<psi_0|psi_t>|^2 of each trajectory with its initial state.

    engine="dense": the dense objective (``tdvp_objective``);
    engine="pallas": ``tdvp_objective_pallas``, on CUDA one K4 launch
    forward and one K5 launch backward per inner step for the family.

    ``params0`` (15,) is the initial state's parameters; without it the
    ground state of tfim(g0) is found first (L-BFGS, ``gs_steps``,
    ``generator``).  ``mesh`` (``parallel.mesh``) splits the trajectories
    over its devices; each advances as it would in one batch (adam acts
    row by row).  ``device`` defaults to g1s's for a tensor, else to the
    card (``config.resolve_device``).  The precision is float32 if
    ``params0`` or else ``g1s`` is a float32 tensor (so the card's numerics
    run on the CPU too), else by device: float64 on the CPU, float32 on
    CUDA.

    Returns (times (n_steps,), loschmidt (len(g1s), n_steps)).
    """
    if engine not in ("dense", "pallas"):
        raise ValueError(f"engine must be 'dense' or 'pallas', got {engine!r}")
    device = resolve_device(device, g1s)
    f32 = next((t for t in (params0, g1s) if isinstance(t, torch.Tensor) and t.dtype == torch.float32), None)
    cdtype, rdtype = default_dtypes(device, like=f32)
    g1s = torch.as_tensor(g1s).to(device, rdtype)
    if params0 is None:
        params0 = find_ground_state(
            tfim(g0), D=2, ansatz="full15", method="lbfgs", steps=gs_steps,
            generator=generator, device=device,
        ).params
    params0 = torch.as_tensor(params0).to(device, rdtype)
    dt = t_max / n_steps
    Ws = torch.linalg.matrix_exp(-1j * tfim_matrix(g1s).to(cdtype) * (2 * dt))

    def u2t(p):
        return unitary_to_tensor(ansatze.shallow_full_state(p))

    objective = tdvp_objective_pallas if engine == "pallas" else tdvp_objective
    extra = (pallas_iters,) if engine == "pallas" else ()

    def trajectories(ps, Ws):
        """The overlap densities (n, n_steps) of the trajectories of a
        block of rows, on its device."""
        n = ps.shape[0]
        with torch.no_grad():
            A0 = u2t(params0.to(ps.device)).expand(n, 2, 2, 2)
        les = []
        for _ in range(n_steps):
            with torch.no_grad():
                As = u2t(ps)
            ps = _warm_started_minimize(lambda q: objective(As, u2t(q), Ws, *extra).sum(), ps, inner_steps, lr)
            with torch.no_grad():
                ov, _ = right_fixed_point(u2t(ps), A0)
            les.append(ov.abs().square())
        return torch.stack(les, dim=1)

    les = shard_over_sweep(trajectories, mesh)(params0.expand(g1s.shape[0], -1).clone(), Ws)
    times = torch.arange(1, n_steps + 1, dtype=rdtype, device=device) * dt
    return times, les


class NoisyMPSTimeEvolve(MPSTimeEvolve):
    """TDVP stepper whose inner objective is the depolarizing-noise
    density-matrix amplitude (scripts/loschmidt.py:241-277 noisy_obj),
    ``objectives.noise.noisy_tdvp_objective``, with exact gradients
    through the channel."""

    def __init__(self, H, dt: float, depolarizing_prob: float, **kw):
        self.p_noise = depolarizing_prob
        super().__init__(H, dt, **kw)

    def objective(self, A, B, W):
        return noisy_tdvp_objective(A, B, W, self.p_noise)


def batched_noise_sweep(g0: float, g1: float, t_max: float, n_steps: int, noise_levels, inner_steps: int = 80,
                        gs_steps: int = 300, lr: float = 3e-2, generator: torch.Generator | None = None, mesh=None,
                        device=None):
    """The reference's production noise study (scripts/loschmidt.py:335-382,
    one cluster job per depolarizing probability) in lockstep: the ground
    state of tfim(g0) (L-BFGS, ``gs_steps``, the full15 ansatz, the guess
    from ``generator``) quenched to tfim(g1), every noise level advancing
    as one row of an (L, 15) parameter tensor (``_noise_sweep_from``), the
    levels split over the devices of ``mesh`` (``parallel.mesh``).
    ``device`` defaults to ``noise_levels``' for a tensor, else to the card
    (``config.resolve_device``); a float32 ``noise_levels`` tensor sets
    float32, else the device sets the precision.

    Returns (times (n_steps,), rates (L, n_steps)), rate = -log
    |<psi_0|psi_t>|^2 of the evolved pure parametrized state (the noise
    shapes the optimization landscape, as in the reference)."""
    return _batched_noise_sweep(g0, g1, t_max, n_steps, noise_levels, inner_steps, gs_steps, lr, generator,
                                device, mesh)[:2]


def _batched_noise_sweep(g0, g1, t_max, n_steps, noise_levels, inner_steps, gs_steps, lr, generator, device,
                         mesh=None):
    """``batched_noise_sweep``, returning also the final parameters (L, 15)
    and the ground state's (15,): (times, rates, final, ground state)."""
    device = resolve_device(device, noise_levels)
    _, rdtype = default_dtypes(device, like=noise_levels)
    params0 = find_ground_state(tfim(g0), D=2, ansatz="full15", method="lbfgs", steps=gs_steps,
                                generator=generator, device=device).params.to(rdtype)
    return _noise_sweep_from(params0, g1, t_max, n_steps, noise_levels, inner_steps, lr, mesh) + (params0,)


def _noise_sweep_from(params0: torch.Tensor, g1: float, t_max: float, n_steps: int, noise_levels,
                      inner_steps: int = 80, lr: float = 3e-2, mesh=None):
    """``batched_noise_sweep`` from the initial parameters ``params0`` (15,)
    on their device and in their precision: per outer step of dt = t_max /
    n_steps, ``inner_steps`` constant-rate adam steps from a fresh state of
    the summed noisy objective (adam is elementwise, so each row descends
    as it would alone, as the JAX package's vmap does; W = expm(-i h(g1)
    2 dt) on the host in complex128), then each row's overlap density with
    the initial state; the levels split over the devices of ``mesh``.
    Returns (times, rates, the final parameters (L, 15))."""
    cdtype = complex_type(params0)
    device = params0.device
    ps_noise = torch.as_tensor(noise_levels, dtype=torch.float64).to(device, params0.dtype)
    dt = t_max / n_steps
    W_host = torch.from_numpy(scipy.linalg.expm(-1j * tfim(g1).to_matrix() * (2 * dt)))

    def u2t(p):
        return unitary_to_tensor(ansatze.shallow_full_state(p))

    def levels(ps_noise):
        """(rates, final parameters) of a block of noise levels, on its device."""
        dev = ps_noise.device
        W = W_host.to(dev, cdtype)
        p0 = params0.to(dev)
        ps = p0.expand(ps_noise.shape[0], -1).clone()
        with torch.no_grad():
            A0 = u2t(p0)
        les = []
        for _ in range(n_steps):
            with torch.no_grad():
                As = u2t(ps)
            ps = _warm_started_minimize(lambda q: noisy_tdvp_objective(As, u2t(q), W, ps_noise).sum(), ps,
                                        inner_steps, lr)
            with torch.no_grad():
                ov, _ = right_fixed_point(u2t(ps), A0.expand_as(As))
            les.append(ov.abs().square())
        return -torch.log(torch.stack(les, dim=1)), ps

    rates, ps = shard_over_sweep(levels, mesh)(ps_noise)
    times = torch.arange(1, n_steps + 1, dtype=params0.dtype, device=device) * dt
    return times, rates, ps


def noisy_loschmidt_echo_run(g0: float, g1: float, t_max: float, n_steps: int, noise_levels,
                             inner_steps: int = 80, gs_steps: int = 300, generator: torch.Generator | None = None,
                             device=None):
    """The production noise study one trajectory at a time
    (scripts/loschmidt.py:335-382): the ground state of tfim(g0), then per
    noise level ``MPSTimeEvolve`` (p = 0) or ``NoisyMPSTimeEvolve`` under
    tfim(g1).  ``device`` as ``loschmidt_echo_run``.  Returns (times,
    rates (L, n_steps))."""
    device = resolve_device(device)
    gs = find_ground_state(tfim(g0), D=2, ansatz="full15", method="lbfgs", steps=gs_steps,
                           generator=generator, device=device)
    dt = t_max / n_steps
    rates = []
    for p in noise_levels:
        stepper = (MPSTimeEvolve(tfim(g1), dt, inner_steps=inner_steps, device=device) if p == 0 else
                   NoisyMPSTimeEvolve(tfim(g1), dt, p, inner_steps=inner_steps, device=device))
        rates.append(-torch.log(stepper.evolve(gs.params, n_steps).loschmidt))
    times = torch.arange(1, n_steps + 1, dtype=gs.params.dtype, device=device) * dt
    return times, torch.stack(rates)
