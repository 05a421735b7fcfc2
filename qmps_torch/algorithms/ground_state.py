"""Variational ground-state search (counterpart of
``qmps_tpu.algorithms.ground_state``).

Ported: ``find_ground_state`` for every state ansatz of
``circuits.ansatze.STATE_ANSATZE`` ("suN" at any D, "su4" and "full15" at
D = 2, and the shallow circuits "qaoa", "cnot", "cnot3",
"cnot_nonuniform" and "exact_after_4") with the adam and L-BFGS
optimizers; the energy is ``energy_exact_env``.  And
``ground_state_deep_brickwork``, adam over the bricks of a deep brick
wall (``circuits.brickwork_deep``) with a cold environment solve a step
or the recycled one.  The rotosolve and scipy methods and the
reference-named optimizer classes wait (ROADMAP.md, "The rest").

The JAX package compiles one cached program per configuration and
finishes U and A inside it (TPU workarounds); here the loops run eagerly.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..circuits import ansatze
from ..config import default_dtypes, resolve_device
from ..embed.unitaries import unitary_to_tensor
from ..ham.hamiltonian import as_host_matrix
from ..objectives.energy import energy_exact_env
from ..optim.minimize import adam_steps, cosine_decay, minimize_adam, minimize_lbfgs


@dataclasses.dataclass
class GroundStateResult:
    params: torch.Tensor
    energy: float
    history: Optional[torch.Tensor]
    U: torch.Tensor
    A: torch.Tensor


def _ansatz_builder(ansatz: str, D: int):
    """params -> (..., 2D, 2D) state unitary (ground_state.py:38-45)."""
    if ansatz in ("full15", "su4") and D != 2:
        raise ValueError(f"the {ansatz!r} ansatz is a D = 2 state gate, got D = {D}")
    if ansatz not in ansatze.STATE_ANSATZE:
        raise ValueError(f"unknown ansatz {ansatz!r}")
    unitary = ansatze.STATE_ANSATZE[ansatz]
    return lambda p: unitary(D, p)


def n_params(ansatz: str, D: int, depth: int = 2) -> int:
    if ansatz == "suN":
        return (2 * D) ** 2 - 1
    if ansatz == "full15":
        return 15
    if ansatz == "su4":
        return 15
    per_layer = {"qaoa": 2, "cnot": 2, "cnot3": 3, "exact_after_4": 6}.get(ansatz)
    if ansatz == "cnot_nonuniform":
        per_layer = 2 * (int(D).bit_length())
    return per_layer * depth


def find_ground_state(
    H,
    D: int = 2,
    ansatz: str = "suN",
    depth: int = 2,
    method: str = "lbfgs",
    steps: int = 500,
    initial_guess: torch.Tensor | None = None,
    generator: torch.Generator | None = None,
    device=None,
) -> GroundStateResult:
    """Minimize <h> over the circuit-MPS manifold.

    H is a Hamiltonian or a dense 4x4 matrix.  ``generator`` draws the
    initial guess, normal * 0.5 (a CPU generator, seed 0 if None);
    ``device`` defaults to the guess's for a tensor, else to the card
    (``config.resolve_device``).  A tensor guess sets the precision;
    otherwise the CPU runs in float64, CUDA in float32.  adam decays its
    rate from 1e-2 as the JAX package's does.
    """
    build = _ansatz_builder(ansatz, D)
    if method not in ("adam", "lbfgs"):
        raise NotImplementedError(
            f"method {method!r} is not ported: rotosolve and the scipy bridge wait "
            "(ROADMAP.md, 'The rest'); use 'adam' or 'lbfgs'"
        )
    device = resolve_device(device, initial_guess)
    cdtype, rdtype = default_dtypes(device, initial_guess)
    if initial_guess is None:
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        initial_guess = torch.randn(
            n_params(ansatz, D, depth), generator=generator, dtype=torch.float64
        ) * 0.5
    x0 = torch.as_tensor(initial_guess).to(device, rdtype)
    h = torch.as_tensor(as_host_matrix(H)).to(device, cdtype)

    def loss(p):
        return energy_exact_env(build(p), h)

    res = (minimize_adam if method == "adam" else minimize_lbfgs)(loss, x0, steps=steps)
    with torch.no_grad():
        U = build(res.x)
    return GroundStateResult(
        params=res.x, energy=res.fun, history=res.history, U=U, A=unitary_to_tensor(U)
    )


# -- the shared adam cores (qmps_tpu/algorithms/ground_state.py:61-134) -------


def _recycled_r0(D: int, dtype, device) -> torch.Tensor:
    """Unit-Frobenius identity start of the recycled environment (PSD, so
    power iteration from it is monotone for A == B maps)."""
    return torch.eye(D, dtype=dtype, device=device) / D ** 0.5


def _recycled_adam_core(loss_env, x0: torch.Tensor, r0: torch.Tensor, steps: int, lr: float,
                        recycle_iters: int, final_iters: int = 200, record: bool = True):
    """(x, hist, e): ``minimize_adam`` (the rate decayed as optax's
    ``cosine_decay_schedule(lr, steps, alpha=0.05)``) with environment
    recycling.
    ``loss_env(x, r, iters) -> (values, r_new)``; the environment rides the
    steps detached (the recycled start is an accelerator, not part of the
    differentiated graph) and the loss is the sum of ``values``, so a batch
    of independent rows descends as each row alone.  e is a boosted
    ``final_iters`` evaluation at the returned x, never the recycled
    residual; hist (if ``record``) the pre-update summed losses."""
    env = [r0]

    def loss(x):
        v, r_new = loss_env(x, env[0], recycle_iters)
        env[0] = r_new.detach()
        return v.sum()

    x, hist = adam_steps(loss, x0, steps, lr, cosine_decay(steps), record=record)
    with torch.no_grad():
        e, _ = loss_env(x, env[0], final_iters)
    return x, hist, e


# -- deep brickwork (BASELINE config 5: D = 32-64 brick-wall uMPS) -----------


def _deep_bw_isometry(p: torch.Tensor, D: int, depth: int) -> torch.Tensor:
    """(..., 2D, D) isometry of the wall's tensor, rows (i, s)."""
    from ..circuits.brickwork_deep import brick_wall_tensor

    A = brick_wall_tensor(p, D, depth)
    return A.transpose(-3, -2).reshape(A.shape[:-3] + (2 * D, D))


def ground_state_deep_brickwork(
    H,
    D: int,
    depth: Optional[int] = None,
    steps: int = 400,
    lr: float = 0.05,
    generator: torch.Generator | None = None,
    initial_guess: torch.Tensor | None = None,
    power_iters: Optional[int] = None,
    dense_env_max_D: Optional[int] = None,
    recycle: bool = True,
    recycle_iters: int = 24,
    device=None,
) -> GroundStateResult:
    """Variational uMPS ground state at D = 2^(n-1) over a depth-d wall of
    SU(4) KAK bricks (``circuits.brickwork_deep``), adam with the cosine-
    decayed rate.

    ``recycle`` (default): the environment rides the steps and is refined
    by ``recycle_iters`` warm power matvecs a step
    (``optim.riemann.isometry_energy_warm``, its implicit adjoint); the
    last history entry is a 200-iteration evaluation at the returned
    parameters.  ``recycle=False``: a cold solve every step
    (``isometry_energy``), dense repeated squaring up to
    ``dense_env_max_D`` (None: 8 on the CPU, 32 on CUDA) and the matvec
    Krylov path above it with ``power_iters`` (None: 120).  Those two
    configure the cold solver only, and raise with ``recycle=True``.

    ``depth`` None is n + 1.  The start is normal * 0.3 drawn from
    ``generator`` (a CPU generator, seed 0 if None) unless
    ``initial_guess`` is given; ``device`` as ``config.resolve_device``, a
    tensor guess sets the precision (else ``config.default_dtypes``).
    Returns a GroundStateResult whose ``energy`` = history[-1] is the
    returned state's.
    """
    from ..circuits.brickwork_deep import _n_qubits, brick_wall_unitary, n_brick_params
    from ..optim.riemann import isometry_energy, isometry_energy_warm

    n = _n_qubits(D)
    if depth is None:
        depth = n + 1
    if recycle and (dense_env_max_D is not None or power_iters is not None):
        raise ValueError("dense_env_max_D/power_iters configure the cold per-step "
                         "solver; pass recycle=False to use them")
    device = resolve_device(device, initial_guess)
    cdtype, rdtype = default_dtypes(device, initial_guess)
    if initial_guess is None:
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        initial_guess = torch.randn(n_brick_params(n, depth), generator=generator, dtype=torch.float64) * 0.3
    x0 = torch.as_tensor(initial_guess).to(device, rdtype)
    h = torch.as_tensor(as_host_matrix(H)).to(device, cdtype)

    if recycle:
        def loss_env(p, r, iters):
            return isometry_energy_warm(_deep_bw_isometry(p, D, depth), h, D, r, iters)

        x, hist, e = _recycled_adam_core(loss_env, x0, _recycled_r0(D, cdtype, device), steps, lr,
                                         recycle_iters)
        hist = torch.cat([hist, e[None]])
    else:
        if dense_env_max_D is None:
            dense_env_max_D = 32 if device.type == "cuda" else 8
        dense = D <= dense_env_max_D
        iters = 120 if power_iters is None else power_iters
        res = minimize_adam(lambda p: isometry_energy(_deep_bw_isometry(p, D, depth), h, D, dense, iters), x0,
                            steps, lr)
        x, hist = res.x, torch.cat([res.history, res.history.new_tensor([res.fun])])
    with torch.no_grad():
        U = brick_wall_unitary(x, n, depth)
    return GroundStateResult(params=x, energy=float(hist[-1]), history=hist, U=U, A=unitary_to_tensor(U))
