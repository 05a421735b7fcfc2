"""Variational ground-state search (counterpart of
``qmps_tpu.algorithms.ground_state``).

Ported: ``find_ground_state`` for the "full15" D = 2 ansatz with the adam
and L-BFGS optimizers; the energy is ``energy_exact_env``.  The other
ansatze ("suN" and "su4" need core/lie, ROADMAP.md item 2; the shallow
circuits item 9), the rotosolve and scipy methods (item 19) and the
reference-named optimizer classes wait.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..circuits import ansatze
from ..config import default_dtypes
from ..embed.unitaries import unitary_to_tensor
from ..ham.hamiltonian import as_host_matrix
from ..objectives.energy import energy_exact_env
from ..optim.minimize import minimize_adam, minimize_lbfgs


@dataclasses.dataclass
class GroundStateResult:
    params: torch.Tensor
    energy: float
    history: Optional[torch.Tensor]
    U: torch.Tensor
    A: torch.Tensor


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
    ``device`` defaults to the guess's (CPU without one).  The CPU runs in
    float64, CUDA in float32.  adam decays its rate from 1e-2 as the JAX
    package's does.
    """
    if ansatz != "full15":
        raise NotImplementedError(
            f"ansatz {ansatz!r} is not ported: 'suN'/'su4' need core/lie (ROADMAP.md, "
            "item 2), the shallow circuit ansatze wait for item 9; use 'full15'"
        )
    if D != 2:
        raise ValueError(f"the 'full15' ansatz is a D = 2 state gate, got D = {D}")
    if method not in ("adam", "lbfgs"):
        raise NotImplementedError(
            f"method {method!r} is not ported: rotosolve and the scipy bridge wait "
            "(ROADMAP.md, item 19); use 'adam' or 'lbfgs'"
        )
    if device is None:
        device = initial_guess.device if isinstance(initial_guess, torch.Tensor) else "cpu"
    device = torch.device(device)
    cdtype, rdtype = default_dtypes(device)
    if initial_guess is None:
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        initial_guess = torch.randn(
            n_params(ansatz, D, depth), generator=generator, dtype=torch.float64
        ) * 0.5
    x0 = torch.as_tensor(initial_guess).to(device, rdtype)
    h = torch.as_tensor(as_host_matrix(H)).to(device, cdtype)
    build = ansatze.shallow_full_state

    def loss(p):
        return energy_exact_env(build(p), h)

    res = (minimize_adam if method == "adam" else minimize_lbfgs)(loss, x0, steps=steps)
    with torch.no_grad():
        U = build(res.x)
    return GroundStateResult(
        params=res.x, energy=res.fun, history=res.history, U=U, A=unitary_to_tensor(U)
    )
