"""Real-time TDVP quenches (counterpart of ``qmps_tpu.algorithms.evolve``).

Per time step, the candidate state's parameters maximize the per-site
overlap density with W|psi(t)> (qmps/new_time_evolve.py:252-302), by an
adam loop warm-started from the current parameters.

Ported: ``batched_quench_sweep``, a family of quench trajectories in
lockstep, with both engines.  ``MPSTimeEvolve`` (with checkpoint and
resume), ``compile_state_to_ansatz``, ``loschmidt_echo_run`` and the noise
sweeps wait (ROADMAP.md, section 1 item 1).  The JAX package's ``chunk``, ``mesh``
and compiled-program cache are TPU compile workarounds and have no
counterpart here.
"""
from __future__ import annotations

import torch

from ..circuits import ansatze
from ..config import default_dtypes, resolve_device
from ..embed.unitaries import unitary_to_tensor
from ..ham.hamiltonian import tfim
from ..mps.transfer import right_fixed_point
from ..objectives.overlap import tdvp_objective, tdvp_objective_pallas
from ..optim.minimize import adam_steps
from ..parallel.sweep import tfim_matrix
from .ground_state import find_ground_state


def _warm_started_minimize(loss, p: torch.Tensor, inner_steps: int, lr: float) -> torch.Tensor:
    """``inner_steps`` constant-rate adam steps on ``loss`` from p, with a
    fresh optimizer state (re-initialised at every outer step)."""
    return adam_steps(loss, p, inner_steps, lr)[0]


def batched_quench_sweep(
    g0: float,
    g1s,
    t_max: float,
    n_steps: int,
    inner_steps: int = 80,
    gs_steps: int = 300,
    lr: float = 3e-2,
    generator: torch.Generator | None = None,
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
    ``generator``).  ``device`` defaults to g1s's for a tensor, else to the
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

    if engine == "pallas":
        def objective(As, Bs):
            return tdvp_objective_pallas(As, Bs, Ws, pallas_iters)
    else:
        def objective(As, Bs):
            return tdvp_objective(As, Bs, Ws)

    n = g1s.shape[0]
    ps = params0.expand(n, -1).clone()
    with torch.no_grad():
        A0 = u2t(params0).expand(n, 2, 2, 2)
    les = []
    for _ in range(n_steps):
        with torch.no_grad():
            As = u2t(ps)
        ps = _warm_started_minimize(lambda q: objective(As, u2t(q)).sum(), ps, inner_steps, lr)
        with torch.no_grad():
            ov, _ = right_fixed_point(u2t(ps), A0)
        les.append(ov.abs().square())
    times = torch.arange(1, n_steps + 1, dtype=rdtype, device=device) * dt
    return times, torch.stack(les, dim=1)
