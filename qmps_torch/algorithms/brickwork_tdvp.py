"""Gen-2 brickwork TDVP stack: Represent / Optimize / Evolve (counterpart
of ``qmps_tpu.algorithms.brickwork_tdvp``).

22-parameter brickwork states (a 15-parameter SU(4) U1 and a 7-parameter
first-column U2), ground states through the windowed energies, and TDVP
time evolution through the normalization-free overlap objective
(new_tdvp/ClassicalTDVPStripped.py's top layer).  The JAX package's
jit-scans are PyTorch loops, its vmapped multi-start one batched adam, and
its random starts come from an explicit ``torch.Generator``.

Device rule (``config.resolve_device``): a function given tensors runs
where they are, in their precision; one given floats, numpy arrays or a
seed runs on the card unless it is passed ``device="cpu"``, in float64 on
the CPU and float32 on CUDA.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..circuits.brickwork import (
    bricks_to_tensor_left,
    bw_state,
    exact_right_env,
    expectation_2site,
    expectation_4site,
    manifold_overlap,
    param_bricks,
)
from ..config import default_dtypes, resolve_device
from ..mps import transfer as tr
from ..mps.imps import iMPS, merge
from ..objectives.overlap import tdvp_objective
from ..optim.minimize import OptResult, adam_steps, exponential_decay, minimize_adam, minimize_lbfgs


def _blocked(params: torch.Tensor) -> torch.Tensor:
    """22 params (..., 22) -> the blocked left-canonical tensor in the
    standard (d, D, D) = (4, 2, 2) order."""
    return bricks_to_tensor_left(*param_bricks(params)).transpose(-3, -2)


def brickwork_energy(params: torch.Tensor, O) -> torch.Tensor:
    """Windowed <O> of the brickwork state; the 2- or 4-site window by O's
    size (OverlapCalculator.expectation_value)."""
    U1, U2 = param_bricks(params)
    O = torch.as_tensor(O).to(U1.device, U1.dtype)
    if O.shape[-1] == 4:
        return expectation_2site(U1, U2, O)
    return expectation_4site(U1, U2, O)


def bw_layer_energy(params: torch.Tensor, h) -> torch.Tensor:
    """2-layer bwMPS energy averaged over 2- and 3-cell windows
    (BrickWallMPS.py optimize_2layer_bwmps / ClassicalTDVPStripped.py:198-225)."""
    U1, U2 = param_bricks(params)
    h = torch.as_tensor(h).to(U1.device, U1.dtype)
    I2 = torch.eye(2, dtype=U1.dtype, device=U1.device)
    e = 0.0
    for l, H in ((2, torch.kron(torch.kron(I2, h), I2)),
                 (3, torch.kron(torch.kron(torch.kron(torch.kron(I2, I2), h), I2), I2))):
        psi = bw_state(U1, U2, l)
        e = e + torch.einsum("...i,ij,...j->...", psi.conj(), H, psi).real
    return e / 2


def optimize_brickwork(h, steps: int = 400, method: str = "lbfgs",
                       generator: torch.Generator | None = None, device=None) -> OptResult:
    """Brickwork ground-state search (Optimize.optimize analogue) from 22
    uniform [0, 1) parameters drawn with ``generator`` (seed 0 if None);
    where h is and in its precision if it is a tensor."""
    device = resolve_device(device, h)
    _, rdtype = default_dtypes(device, h)
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    p0 = torch.rand(22, generator=generator, dtype=torch.float64).to(device, rdtype)
    h = torch.as_tensor(h).to(device)

    def loss(p):
        return bw_layer_energy(p, h)

    if method == "lbfgs":
        return minimize_lbfgs(loss, p0, steps=steps)
    return minimize_adam(loss, p0, steps=steps)


def evolve_cost_exact_env(params_new, params_cur, W) -> torch.Tensor:
    """-|overlap|^2 with the exact brickwork environment
    (Evolve.exact_cost_function, ClassicalTDVPStripped.py:778-791),
    including the reference's unit-Frobenius environment normalization,
    under which the value also tracks the bond-spectrum purity; the
    stepper below drives ``evolve_cost_eig`` instead."""
    U1, U2 = param_bricks(params_cur)
    U1p, U2p = param_bricks(params_new)
    U1d, U2d = U1p.mH, U2p.mH
    _, Mr = exact_right_env(U1, U2, U1d, U2d)
    W = torch.as_tensor(W).to(U1.device, U1.dtype)
    return -manifold_overlap(U1, U2, U1d, U2d, Mr, Mr.mH, W).abs().square()


def _eig_cost(A: torch.Tensor, params_new: torch.Tensor, W: torch.Tensor) -> torch.Tensor:
    return -tdvp_objective(A, _blocked(params_new), W).square()


def evolve_cost_eig(params_new, params_cur, W) -> torch.Tensor:
    """-|x|^2 with x the dominant eigenvalue of the blocked mixed transfer
    map E = Map(W (A x A), B x B): the normalization-free per-site fidelity
    density (the brickwork form of the gen-1 TDVP objective)."""
    return _eig_cost(_blocked(params_cur), params_new, torch.as_tensor(W))


@dataclasses.dataclass
class BrickworkEvolver:
    """Evolve.time_evolve analogue: warm-started gradient TDVP steps, each
    ``inner_steps`` adam steps of ``evolve_cost_eig`` from the current
    parameters with a fresh optimizer state.  Runs where p0 is (else W),
    in its precision, for a tensor, else on the card."""

    W: torch.Tensor
    inner_steps: int = 100
    lr: float = 2e-2
    device: str | torch.device | None = None

    def time_evolve(self, p0, n_steps: int):
        """(trajectory (n_steps + 1, 22) from p0, costs (n_steps,))."""
        like = p0 if isinstance(p0, torch.Tensor) else self.W
        device = resolve_device(self.device, like)
        cdtype, rdtype = default_dtypes(device, like)
        W = torch.as_tensor(self.W).to(device, cdtype)
        params = torch.as_tensor(p0).to(device, rdtype)
        traj, costs = [params], []
        for _ in range(n_steps):
            with torch.no_grad():
                A = _blocked(params)
            params, _ = adam_steps(lambda q: _eig_cost(A, q, W), params, self.inner_steps, self.lr)
            with torch.no_grad():
                costs.append(_eig_cost(A, params, W))  # the value at the returned params
            traj.append(params)
        return torch.stack(traj), torch.stack(costs)


def quench_window_gate(h, dt: float) -> np.ndarray:
    """The calibrated 4-site Trotter window gate for brickwork TDVP:
    W = expm(-i (4/3) dt (h_01 + h_12 + h_23)), host numpy (16, 16).

    The stepper's objective inserts W once per 2-cell period (disjoint
    4-site tiling), so the three window-internal bonds carry the
    Hamiltonian-time of all four bonds per period: tau = (4/3) dt with
    uniform internal weights (brickwork_tdvp.py:134-153)."""
    import scipy.linalg

    h = np.asarray(h)
    I2, I4 = np.eye(2), np.eye(4)
    H4 = np.kron(np.kron(I2, h), I2) + np.kron(h, I4) + np.kron(I4, h)
    return scipy.linalg.expm(-1j * H4 * (4.0 / 3.0) * dt)


def _compile_losses(Ablk: torch.Tensor, ps: torch.Tensor) -> torch.Tensor:
    """Per row of ps (n, 22): -|lam(A, B)|^2 / |lam(B, B)|, the negated
    per-cell overlap density of the bricks with the blocked target."""
    Bb = _blocked(ps)
    lam_ab = tr.dominant_eigval_dense(tr.transfer_dense(Ablk, Bb))
    lam_bb = tr.dominant_eigval_dense(tr.transfer_dense(Bb, Bb))
    return -(lam_ab.abs().square() / lam_bb.abs())


def compile_tensor_to_bricks(A: torch.Tensor, steps: int = 1500, n_starts: int = 8, lr: float = 5e-2,
                             generator: torch.Generator | None = None):
    """Warm-start the brickwork pipeline from a 1-site MPS tensor A
    (2, 2, 2) (e.g. a classically found ground state): fit the 22 brick
    parameters by maximizing the per-cell overlap density with the 2-site
    blocking of A.  ``n_starts`` uniform starts (``generator``, seed 0 if
    None) run as one batched adam (elementwise, so each row is its own
    adam) with the rate decayed as optax's exponential_decay(lr, steps // 2,
    0.05); the best row wins.  Runs where A is.  Returns (params, overlap)."""
    Ablk = iMPS([merge(A, A)]).left_canonicalise()[0]
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    p0s = torch.rand((n_starts, 22), generator=generator, dtype=torch.float64)
    p0s = p0s.to(A.device, A.real.dtype)
    ps, _ = adam_steps(lambda p: _compile_losses(Ablk, p).sum(), p0s, steps, lr,
                       exponential_decay(steps // 2, 0.05))
    with torch.no_grad():
        finals = _compile_losses(Ablk, ps)
    i = torch.argmin(finals)
    return ps[i], -finals[i]


def loschmidt_echo_brickwork(p0, W, n_steps: int, inner_steps: int = 100, device=None):
    """Gen-2 Loschmidt pipeline (new_tdvp/LoschmidtEchos.py): evolve and
    report the per-cell overlap |<psi_0|psi_t>|^2 of the blocked tensors
    at each step; where p0 is (else W) for a tensor, in its precision.
    Returns (overlaps (n_steps,), trajectory, costs)."""
    ev = BrickworkEvolver(W, inner_steps=inner_steps, device=device)
    traj, costs = ev.time_evolve(p0, n_steps)
    with torch.no_grad():
        psi0 = iMPS([_blocked(traj[0])])
        les = torch.stack([iMPS([_blocked(p)]).overlap(psi0) for p in traj[1:]])
    return les, traj, costs
