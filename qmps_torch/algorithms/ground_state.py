"""Variational ground-state search (counterpart of
``qmps_tpu.algorithms.ground_state``).

``find_ground_state`` for every state ansatz of
``circuits.ansatze.STATE_ANSATZE`` ("suN" at any D, "su4" and "full15" at
D = 2, and the shallow circuits "qaoa", "cnot", "cnot3",
"cnot_nonuniform" and "exact_after_4"), the energy ``energy_exact_env``,
with adam, L-BFGS, rotosolve or a scipy method ("Nelder-Mead", "Powell",
...); the optimizer classes named after the reference's family
(qmps/ground_state.py:120-526), the noisy and sampled ones among them; and
``ground_state_deep_brickwork``, adam over the bricks of a deep brick wall
(``circuits.brickwork_deep``) with a cold environment solve a step or the
recycled one.

The JAX package compiles one cached program per configuration, finishes U
and A inside it, and keeps a scipy objective that draws shot noise out of
jit (TPU and jit workarounds); here the loops run eagerly.  Random starts
come from ``torch.Generator``s.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Optional

import torch

from ..circuits import ansatze
from ..config import default_dtypes, resolve_device
from ..embed.unitaries import unitary_to_tensor
from ..ham.hamiltonian import Hamiltonian, as_host_matrix
from ..objectives.energy import energy_exact_env, energy_joint_env_purity, energy_two_site
from ..optim.minimize import (
    OptResult,
    adam_steps,
    cosine_decay,
    minimize_adam,
    minimize_lbfgs,
    minimize_scipy,
)
from ..optim.rotosolve import rotosolve
from ..utils.profiling import span


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


def _start(n: int, scale: float, generator: torch.Generator | None, seed: int = 0) -> torch.Tensor:
    """normal * scale of length n in float64, from ``generator`` (a CPU
    generator seeded ``seed`` if None) on its device."""
    if generator is None:
        generator = torch.Generator().manual_seed(seed)
    return torch.randn(n, generator=generator, dtype=torch.float64, device=generator.device) * scale


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

    H is a Hamiltonian or a dense 4x4 matrix.  ``method``: "adam" (the
    rate decayed from 1e-2 as the JAX package's), "lbfgs", "rotosolve"
    (steps // 10 double-rotosolve sweeps) or a scipy method
    ("Nelder-Mead", "Powell", ...; at most ``steps`` iterations).  ``generator`` draws the initial
    guess, normal * 0.5 (a CPU generator, seed 0 if None); ``device``
    defaults to the guess's for a tensor, else to the card
    (``config.resolve_device``).  A tensor guess sets the precision;
    otherwise the CPU runs in float64, CUDA in float32.
    """
    build = _ansatz_builder(ansatz, D)
    device = resolve_device(device, initial_guess)
    cdtype, rdtype = default_dtypes(device, initial_guess)
    if initial_guess is None:
        initial_guess = _start(n_params(ansatz, D, depth), 0.5, generator)
    x0 = torch.as_tensor(initial_guess).to(device, rdtype)
    h = torch.as_tensor(as_host_matrix(H)).to(device, cdtype)

    def loss(p):
        return energy_exact_env(build(p), h)

    res = _run(loss, x0, method, steps)
    with torch.no_grad():
        U = build(res.x)
    return GroundStateResult(
        params=res.x, energy=res.fun, history=res.history, U=U, A=unitary_to_tensor(U)
    )


def _run(loss, x0: torch.Tensor, method: str, steps: int) -> OptResult:
    if method == "adam":
        return minimize_adam(loss, x0, steps=steps)
    if method == "lbfgs":
        return minimize_lbfgs(loss, x0, steps=steps)
    if method == "rotosolve":
        x, hist = rotosolve(loss, x0, n_sweeps=max(1, steps // 10))
        with torch.no_grad():
            return OptResult(x=x, fun=float(loss(x)), history=hist, nit=steps)
    # the JAX package's bridge leaves scipy at maxiter 10000 whatever
    # ``steps`` says; the reference's settings pass maxiter to scipy
    return minimize_scipy(loss, x0, method=method, maxiter=steps)


# -- the reference-named optimizer classes (qmps_tpu/algorithms/ground_state.py:242-539)


class _OptimizerBase:
    """The settings-dict interface of qmps/tools.py:203-284.  Subclasses set
    ``initial_guess`` (a tensor on their device, in its real type) and
    ``objective_function``."""

    def __init__(self):
        self.settings = {
            "maxiter": 500,
            "verbose": False,
            "method": "lbfgs",
            "tol": 1e-8,
            "store_values": True,
        }
        self.obj_fun_values = None
        self.optimized_result: OptResult | None = None

    def _place(self, H, initial_guess, n: int, scale: float, generator, device, seed: int = 0):
        """The device and types (``config``'s rules), the Hamiltonian matrix
        on them and the initial guess: ``initial_guess``, else normal *
        ``scale`` from ``generator``."""
        self.device = resolve_device(device, initial_guess)
        self.cdtype, rdtype = default_dtypes(self.device, initial_guess)
        if H is not None:
            self.h = torch.as_tensor(as_host_matrix(H)).to(self.device, self.cdtype)
        if initial_guess is None:
            initial_guess = _start(n, scale, generator, seed)
        self.initial_guess = torch.as_tensor(initial_guess).to(self.device, rdtype)

    def change_settings(self, new_settings):
        self.settings.update(new_settings)

    def objective_function(self, params):
        raise NotImplementedError

    def optimize(self) -> OptResult:
        res = _run(self.objective_function, self.initial_guess, self.settings["method"],
                   self.settings["maxiter"])
        self.optimized_result = res
        if res.history is not None:
            self.obj_fun_values = res.history
        self.update_state()
        return res

    def update_state(self):
        pass


class NonSparseFullEnergyOptimizer(_OptimizerBase):
    """Full SU(2D) parametrization, exact environment
    (qmps/ground_state.py:230-269)."""

    def __init__(self, H, D: int = 2, initial_guess=None, generator=None, device=None):
        super().__init__()
        self.D = D
        self._place(H, initial_guess, (2 * D) ** 2 - 1, 0.5, generator, device)

    def objective_function(self, params):
        return energy_exact_env(ansatze.full_state_suN(params, self.D), self.h)

    def update_state(self):
        self.U = ansatze.full_state_suN(self.optimized_result.x, self.D)


class SparseFullEnergyOptimizer(_OptimizerBase):
    """Shallow-ansatz optimizer, with the exact environment or with the
    environment optimized jointly under the purity penalty
    (qmps/ground_state.py:120-228)."""

    def __init__(self, H, D: int = 2, depth: int = 2, ansatz: str = "cnot",
                 optimize_environment: bool = False, initial_guess=None, generator=None, device=None):
        super().__init__()
        self.D = D
        self.optimize_environment = optimize_environment
        if optimize_environment:
            self._np, self.build = 30, None
        else:
            self.build = _ansatz_builder(ansatz, D)
            self._np = n_params(ansatz, D, depth)
        self._place(H, initial_guess, self._np, 0.5, generator, device)

    def objective_function(self, params):
        if self.optimize_environment:
            return energy_joint_env_purity(params, self.h)
        return energy_exact_env(self.build(params), self.h)

    def update_state(self):
        if not self.optimize_environment:
            self.U = self.build(self.optimized_result.x)


class NoisyNonSparseFullEnergyOptimizer(_OptimizerBase):
    """The 15-parameter SU(4) state ("full15") under depolarizing noise
    after every moment, exact environment (qmps/ground_state.py:337-418),
    differentiable in the parameters and the noise strength.

    ``simulation``: "density_matrix" (the exact channel,
    ``objectives.noise``) or "trajectories" (``n_traj`` Monte-Carlo
    trajectories, ``objectives.trajectories``).  Trajectory mode draws its
    uniforms once per instance from ``traj_generator`` (a CPU generator,
    seed 42, if None) and keeps them (common random numbers), so the
    objective is a smooth deterministic function to descend."""

    def __init__(self, H, depolarizing_prob: float, initial_guess=None, generator=None,
                 simulation: str = "density_matrix", n_traj: int = 256, traj_generator=None, device=None):
        super().__init__()
        if simulation not in ("density_matrix", "trajectories"):
            raise ValueError(f"unknown simulation mode {simulation!r}")
        self.p_noise = depolarizing_prob
        self.simulation = simulation
        self.n_traj = n_traj
        self.traj_generator = torch.Generator().manual_seed(42) if traj_generator is None else traj_generator
        self._us = None
        self._place(H, initial_guess, 15, 0.5, generator, device)

    def objective_function(self, params):
        from ..env.exact import get_env_exact
        from ..objectives.noise import _energy_ops, noisy_energy

        ops, n = ansatze.shallow_full_state_ops(params)
        V = get_env_exact(ansatze.shallow_full_state(params))
        if self.simulation == "trajectories":
            from ..objectives.trajectories import _trajectory_energy_from, _uniforms

            if self._us is None:
                circ, nq, _ = _energy_ops(ops, V)
                self._us = _uniforms(self.traj_generator, (self.n_traj, len(circ), nq))
            return _trajectory_energy_from(ops, V, self.h, self.p_noise, self._us)
        return noisy_energy(ops, n, V, self.h, self.p_noise)


class NoisySparseFullEnergyOptimizer(_OptimizerBase):
    """A shallow-ansatz state under depolarizing noise
    (qmps/ground_state.py:420-480)."""

    def __init__(self, H, depolarizing_prob: float, D: int = 2, depth: int = 2, ansatz: str = "cnot",
                 initial_guess=None, generator=None, device=None):
        super().__init__()
        self.p_noise = depolarizing_prob
        self.D = D
        self.ansatz = ansatz
        self._place(H, initial_guess, n_params(ansatz, D, depth), 0.5, generator, device)

    def objective_function(self, params):
        from ..env.exact import get_env_exact
        from ..objectives.noise import noisy_energy

        ops, n = ansatze.STATE_ANSATZE_OPS[self.ansatz](self.D, params)
        V = get_env_exact(ansatze.STATE_ANSATZE[self.ansatz](self.D, params))
        return noisy_energy(ops, n, V, self.h, self.p_noise)


class NoisySparseSampledEnergyOptimizer(_OptimizerBase):
    """Noise and finite shots (a working version of the reference's
    unfinished qmps/ground_state.py:482-526): the energy is measured Pauli
    string by Pauli string on the state with ``n_samples`` shots a string.
    Shot noise makes the objective stochastic: every evaluation draws
    fresh shots from ``generator`` (on the device; seed 17 if None), which
    also draws the initial guess.  Pair it with a scipy method
    (Nelder-Mead by default, or Powell), as the reference intended."""

    def __init__(self, H: Hamiltonian, depolarizing_prob: float = 0.0, D: int = 2, depth: int = 2,
                 ansatz: str = "cnot", n_samples: int = 10000, initial_guess=None, generator=None,
                 device=None):
        super().__init__()
        if not isinstance(H, Hamiltonian):
            raise TypeError("the sampled optimizer needs a Hamiltonian: its Pauli strings are measured")
        self.H = H
        self.p_noise = depolarizing_prob
        self.D = D
        self.ansatz = ansatz
        self.n_samples = n_samples
        device = resolve_device(device, initial_guess)
        self.generator = torch.Generator(device=device).manual_seed(17) if generator is None else generator
        self._place(None, initial_guess, n_params(ansatz, D, depth), 0.5, self.generator, device)
        self.settings["method"] = "Nelder-Mead"

    def optimize(self) -> OptResult:
        if self.settings["method"] in ("adam", "lbfgs", "rotosolve"):
            raise ValueError(
                "the sampled objective draws fresh shot noise at every evaluation and has no "
                "gradient: use a scipy method ('Nelder-Mead', 'Powell'), as the reference does"
            )
        return super().optimize()

    def objective_function(self, params):
        from ..env.exact import get_env_exact
        from ..env.variational import state_circuit_psi
        from ..objectives.sampling import measure_energy

        with torch.no_grad():
            U = ansatze.STATE_ANSATZE[self.ansatz](self.D, params)
            psi = state_circuit_psi(U, get_env_exact(U), 2)
            return measure_energy(self.generator, self.H.strings, psi, qubits=(1, 2), shots=self.n_samples)


class GuessInitialFullParameterOptimizer(_OptimizerBase):
    """Compile a target 2-qubit unitary into the U4 parametrization by
    maximizing the phase-insensitive overlap (qmps/tools.py:287-305), with
    gradients instead of the reference's 4-qubit swap circuit."""

    def __init__(self, target_U, initial_guess=None, generator=None, device=None):
        super().__init__()
        self._place(None, initial_guess, 15, 0.3, generator, device)
        self.target = torch.as_tensor(target_U).to(self.device, self.cdtype)

    def objective_function(self, params):
        from ..core.lie import U4

        # 1 - |tr(target^dag U) / 4|^2
        ov = (self.target.mH @ U4(params)).diagonal().sum() / 4.0
        return 1.0 - ov.abs().square()


class NonSparseFullTwoSiteEnergyOptimizer(_OptimizerBase):
    """The 2-site unit cell of two SU(4)s, the energy averaged over its two
    bonds (qmps/ground_state.py:271-335)."""

    def __init__(self, H, initial_guess=None, generator=None, device=None):
        super().__init__()
        self._place(H, initial_guess, 30, 0.5, generator, device)

    def objective_function(self, params):
        return energy_two_site(ansatze.full_state_su4(params[:15]), ansatze.full_state_su4(params[15:]), self.h)

    def update_state(self):
        self.U1 = ansatze.full_state_su4(self.optimized_result.x[:15])
        self.U2 = ansatze.full_state_su4(self.optimized_result.x[15:])


# -- the shared adam cores (qmps_tpu/algorithms/ground_state.py:61-134) -------


def _recycled_r0(D: int, dtype, device) -> torch.Tensor:
    """Unit-Frobenius identity start of the recycled environment (PSD, so
    power iteration from it is monotone for A == B maps)."""
    return torch.eye(D, dtype=dtype, device=device) / D ** 0.5


def _recycled_adam_core(loss_env, x0: torch.Tensor, r0: torch.Tensor, steps: int, lr: float,
                        recycle_iters: int, final_iters: int = 200, record: bool = True,
                        spans: tuple[str, str, str] | None = None, read=None):
    """(x, hist, e): ``minimize_adam`` (the rate decayed as optax's
    ``cosine_decay_schedule(lr, steps, alpha=0.05)``) with environment
    recycling.
    ``loss_env(x, r, iters) -> (values, r_new)``; the environment rides the
    steps detached (the recycled start is an accelerator, not part of the
    differentiated graph) and the loss is the sum of ``values``, so a batch
    of independent rows descends as each row alone.  e is a boosted
    ``final_iters`` evaluation at the returned x, never the recycled
    residual; hist (if ``record``) the pre-update summed losses.
    ``spans`` (step, backward, final read): span names, the first two
    ``adam_steps``'s, the last opened around the final evaluation; None
    opens none.  ``read(x, r)``, if given, is the final evaluation from the
    last environment r in place of ``final_iters`` matvecs of
    ``loss_env``."""
    env = [r0]

    def loss(x):
        v, r_new = loss_env(x, env[0], recycle_iters)
        env[0] = r_new.detach()
        return v.sum()

    x, hist = adam_steps(loss, x0, steps, lr, cosine_decay(steps), record=record,
                         spans=None if spans is None else spans[:2])
    with torch.no_grad(), (contextlib.nullcontext() if spans is None else span(spans[2])):
        e = loss_env(x, env[0], final_iters)[0] if read is None else read(x, env[0])
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
