"""Quantum many-body scars: PXP TDVP dynamics and Poincare maps
(counterpart of ``qmps_tpu.algorithms.scars``; scars.py and
poincare_map/2body_scars.py of the reference).

The 2-parameter analytic scars tensor A(theta, phi), 2-site unit-cell TDVP
evolution through the mixed-transfer objective (the reference's 8-qubit
Hadamard-test circuit collapses to -|x|, as in ``objectives.overlap``),
the classical TDVP equations for cross-validation, and Poincare-map
ensembles, each one batched computation over the whole ensemble where the
reference ran joblib.Parallel.

Angles are ordered [th1, ph1, ph2, th2] (scars.py:75-86) in the last
dimension; every function broadcasts over the leading ones.  The quantum
paths run in the type of a tensor start (float32 on the card is the
speed type), else float64 on the CPU and float32 on CUDA
(``config.default_dtypes``); the classical ODEs always in float64
(``core/ode.odeint``).  Random starts come from a ``torch.Generator``.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..circuits.ansatze import scars_tensor
from ..config import default_dtypes, resolve_device
from ..core import gates as g
from ..core.ode import odeint
from ..ham.hamiltonian import scars_H
from ..mps.imps import iMPS, merge
from ..mps.transfer import dominant_eigval_dense, transfer_dense
from ..objectives.overlap import mixed_transfer_with_gate
from ..optim.minimize import adam_steps
from ..parallel.mesh import shard_over_sweep

_LR = 2e-2  # the JAX package's quantum ensemble rate


def blocked_tensor(params) -> torch.Tensor:
    """A12 = merge(A(th1, ph1), A(th2, ph2)): the 2-site unit cell
    (scars.py:75-86), (..., 4, 2, 2)."""
    p = g._angle(params)
    return merge(scars_tensor(p[..., 0], p[..., 1]), scars_tensor(p[..., 3], p[..., 2]))


def scars_cost(params, current_params, W16) -> torch.Tensor:
    """-|x| of E = Map(W (A12 x A12), B12 x B12): the TDVP overlap density
    (scars.py:75-111 scars_time_evolve_cost_function, circuit-free), one a
    row of the leading dimensions."""
    return _cost_from(current_params, W16)(params)


def scars_W(mu: float, dt: float) -> torch.Tensor:
    """W = expm(+i dt H(mu)) (the reference's sign convention, scars.py:27),
    by scipy on the host: a complex128 CPU tensor."""
    import scipy.linalg

    return torch.from_numpy(scipy.linalg.expm(1j * dt * scars_H(mu)))


def _cost_from(params: torch.Tensor, W: torch.Tensor):
    """The TDVP cost from the state ``params`` under W: q -> -|x| of
    Map(W (A12 x A12), B12(q) x B12(q)), one a row, with the current
    state's side built once."""
    A12 = blocked_tensor(params)
    WAA, _ = mixed_transfer_with_gate(A12, A12, torch.as_tensor(W))

    def cost(q):
        B12 = blocked_tensor(q)
        return -dominant_eigval_dense(transfer_dense(WAA, merge(B12, B12))).abs()

    return cost


def _tdvp_step(params: torch.Tensor, W: torch.Tensor, inner_steps: int, lr: float):
    """One TDVP step of every row of ``params``: a fresh adam from the
    current angles on the sum of the rows' costs (each cost depends on its
    own row only, and adam acts element by element, so this is one adam a
    row); returns the new angles."""
    cost = _cost_from(params, W)
    p, _ = adam_steps(lambda q: cost(q).sum(), params, inner_steps, lr)
    return p


@dataclasses.dataclass
class ScarsEvolver:
    """TDVP stepper for the scars manifold.

    The Trotter gate spans a 4-site window, so advancing physical time dt
    per step needs W = expm(+i (4 dt) H): the same window-size factor the
    reference hardcodes (scars.py:189 `dt = 4 * t[1]-t[0]`; gen-1 uses 2 dt
    for its 2-site window, scripts/loschmidt.py:341)."""

    mu: float
    dt: float
    inner_steps: int = 120
    lr: float = 2e-2
    window_factor: float = 4.0

    def __post_init__(self):
        self.W = scars_W(self.mu, self.window_factor * self.dt)

    def _step(self, params: torch.Tensor):
        """One TDVP step: (the new angles, the cost at them)."""
        p = _tdvp_step(params, self.W, self.inner_steps, self.lr)
        with torch.no_grad():
            return p, scars_cost(p, params, self.W)

    def simulate(self, p0, n_steps: int, device=None) -> torch.Tensor:
        """simulate_scars analogue (scars.py:157-169): the angle trajectory
        (n_steps, 4) from p0, wrapped to [0, 2 pi)."""
        dev = resolve_device(device, p0)
        _, rt = default_dtypes(dev, like=p0)
        params = torch.as_tensor(p0).to(dev, rt)
        traj = []
        for _ in range(n_steps):
            traj.append(torch.remainder(params, 2 * math.pi))
            params, _ = self._step(params)
        return torch.stack(traj)


# -- classical TDVP equations (scars.py:176-199) -------------------------------


def dtheta_dt(th1, ph1, ph2, th2):
    return torch.tan(th2) * torch.sin(th1) * torch.cos(th1) ** 2 * torch.cos(ph1) + torch.cos(th2) * torch.cos(ph2)


def dphi_dt(th1, ph1, ph2, th2):
    return 2 * torch.tan(th1) * torch.cos(th2) * torch.sin(ph2) - 0.5 * torch.tan(th2) * torch.cos(th1) * torch.sin(
        ph1
    ) * (2 * torch.sin(th2) ** -2 + torch.cos(2 * th1) - 5)


def classical_rhs(angles, t, mu):
    """d/dt of (..., 4) angles [th1, ph1, ph2, th2]: dtheta_dt and dphi_dt
    of both sites, each trigonometric function taken once."""
    a, b = angles[..., ::3], angles[..., 1:3]  # each site's theta and phi (views)
    c, d = b.flip(-1), a.flip(-1)  # the other site's phi and theta
    cos_a, tan_a, tan_d, cos_d = torch.cos(a), torch.tan(a), torch.tan(d), torch.cos(d)
    dth = tan_d * torch.sin(a) * cos_a**2 * torch.cos(b) + cos_d * torch.cos(c)
    dph = 2 * tan_a * cos_d * torch.sin(c) - 0.5 * tan_d * cos_a * torch.sin(b) * (
        2 * torch.sin(d) ** -2 + torch.cos(2 * a) - 5) - mu
    return torch.cat([dth[..., :1], dph, dth[..., 1:]], -1)


def classical_trajectory(y0, ts, mu: float, device=None) -> torch.Tensor:
    """The classical scars equations integrated from y0 (..., 4) in float64
    (scars.py:180-196): (len(ts),) + y0.shape."""
    dev = resolve_device(device, y0, ts)
    y0 = torch.as_tensor(y0).to(dev, torch.float64)
    return odeint(lambda y, t: classical_rhs(y, t, mu), y0, torch.as_tensor(ts).to(dev, torch.float64))


# -- Poincare maps (poincare_map/2body_scars.py) -------------------------------


def scars_energy(params, mu: float) -> torch.Tensor:
    """<H(mu)> per 2-site cell of the scars state, one a row of the leading
    dimensions (for constant-energy initial conditions,
    2body_scars.py:409-454)."""
    return iMPS([blocked_tensor(params)]).E2(torch.from_numpy(scars_H(mu))).real


def poincare_sections(trajs, plane_coord: int = 1, plane_value: float = math.pi, coords=(0, 3)):
    """Interpolated plane crossings of a batch of angle trajectories
    (2body_scars.py:228-257): a list of (n_crossings, len(coords)) numpy
    arrays of the section coordinates, one a trajectory (host numpy, the
    JAX package's code)."""
    if isinstance(trajs, torch.Tensor):
        trajs = trajs.detach().cpu().numpy()
    out = []
    for traj in np.asarray(trajs):
        x = traj[:, plane_coord]
        # angular distance to the plane, mapped to (-pi, pi]: trajectories
        # are wrapped to [0, 2 pi), so the raw difference jumps by ~2 pi at
        # the 0/2 pi seam, where a naive sign test reports spurious crossings
        d = np.mod(x - plane_value + np.pi, 2 * np.pi) - np.pi
        sign = np.sign(d)
        # an upward crossing: a sign change with a step below pi (the seam
        # jump is ~2 pi; a real crossing advances < pi a sample)
        small = np.abs(d[1:] - d[:-1]) < np.pi
        idx = np.where((sign[:-1] < 0) & (sign[1:] >= 0) & small)[0]
        pts = []
        for i in idx:
            f = -d[i] / (d[i + 1] - d[i] + 1e-30)
            pts.append(traj[i] + f * (traj[i + 1] - traj[i]))
        pts = np.array(pts) if pts else np.zeros((0, traj.shape[1]))
        out.append(pts[:, list(coords)])
    return out


def classical_poincare_sweep(keys_or_y0s, ts, mu: float, device=None) -> torch.Tensor:
    """The ensemble of classical trajectories from (B, 4) starts, one
    batched ``odeint`` (replaces joblib.Parallel, 2body_scars.py:14):
    (B, len(ts), 4) in float64."""
    return classical_trajectory(keys_or_y0s, ts, mu, device).movedim(0, -2)


def _project_from_starts(p0s: torch.Tensor, mu: float, target_e: float, steps: int, lr: float) -> torch.Tensor:
    """The starts projected onto the <H(mu)> = target_e shell: adam on the
    sum of the rows' squared energy misses (one adam a row, as the JAX
    package's vmap)."""
    p, _ = adam_steps(lambda p: ((scars_energy(p, mu) - target_e) ** 2).sum(), p0s, steps, lr)
    return p


def constant_energy_initial_conditions(generator, n: int, mu: float, target_e: float, steps: int = 300,
                                       lr: float = 5e-2, device=None) -> torch.Tensor:
    """(n, 4) angles on the <H(mu)> = target_e shell (2body_scars.py:409-454):
    uniform starts in [0.1, 2 pi - 0.1) from ``generator`` (a
    ``torch.Generator`` or a seed; drawn on the CPU in float64), projected
    onto the energy surface by gradient descent (in place of the
    reference's per-point scipy solves)."""
    dev = resolve_device(device)
    _, rt = default_dtypes(dev)
    if not isinstance(generator, torch.Generator):
        generator = torch.Generator().manual_seed(int(generator))
    u = torch.rand(n, 4, generator=generator, dtype=torch.float64)
    p0s = 0.1 + (2 * math.pi - 0.2) * u
    return _project_from_starts(p0s.to(dev, rt), mu, target_e, steps, lr)


def quantum_poincare_sweep(y0s, mu: float, dt: float, n_steps: int, inner_steps: int = 120, mesh=None,
                           device=None) -> torch.Tensor:
    """Ensemble of quantum TDVP trajectories from (B, 4) starts, the
    reference's joblib sweep as one batched computation: each outer step
    runs one adam over the (B, 4) angles of the whole ensemble, warm
    started, on the sum of the B costs; ``mesh`` (``parallel.mesh``)
    splits the ensemble over its devices.  (B, n_steps, 4), wrapped to
    [0, 2 pi), starting with y0s."""
    dev = resolve_device(device, y0s)
    _, rt = default_dtypes(dev, like=y0s)
    W = scars_W(mu, 4.0 * dt)

    def ensemble(ps):
        traj = [torch.remainder(ps, 2 * math.pi)]
        for _ in range(n_steps - 1):
            ps = _tdvp_step(ps, W, inner_steps, _LR)
            traj.append(torch.remainder(ps, 2 * math.pi))
        return torch.stack(traj, 1)

    return shard_over_sweep(ensemble, mesh)(torch.as_tensor(y0s).to(dev, rt))
