"""The benchmark configuration ladder as runnable workloads (counterpart
of ``qmps_tpu.workloads``): each configuration a frozen dataclass whose
``run()`` returns the JAX config's metrics.

1-2. ``GroundStateConfig``: the TFIM ground state at D = 2 and 4;
3. ``QuenchConfig``: the quench pipeline against the exact Loschmidt rate;
4. the phase-diagram sweeps: ``SweepConfig`` (the chart sweeps, D = 2
   "suN" and D = 16 "deep_bw"), ``FusedSweepConfig``, ``GrownSweepConfig``
   and ``StiefelSweepConfig``;
5. ``BrickworkConfig`` (the gen-2 overlap throughput), ``LargeDConfig``
   and ``DeepBrickworkConfig`` (the large-D ground states).

``CONFIG_LADDER`` holds the JAX package's twelve entries and
``run_ladder`` runs them, each under ``utils.profiling.trace`` on
request; ``python -m qmps_torch.workloads`` prints its metrics (on the
card: every configuration defaults to it, in float32).  ``SweepConfig``'s
``use_mesh`` shards the sweep over every card when there is more than
one, as the JAX config does over its devices; the fused config's
``chunk`` (a TPU workaround) has no counterpart.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional, Sequence

import numpy as np
import torch

from .config import FAST_RDTYPE, resolve_device


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _grid(device, n_points: int, g_min: float, g_max: float) -> torch.Tensor:
    """n_points couplings in [g_min, g_max] on the device, float32 on CUDA
    (float64 on the CPU)."""
    dev = resolve_device(device)
    dtype = FAST_RDTYPE if dev.type == "cuda" else torch.float64
    return torch.linspace(g_min, g_max, n_points, dtype=torch.float64).to(dev, dtype)


def _sweep_metrics(sweep, gs: torch.Tensor, n_points: int, g_min: float, g_max: float) -> dict:
    """The sweep configs' run(): one untimed call on gs, the timed one on
    gs + 1e-3, its energies against ``tfim_gs_energy_f64``."""
    from .ham import tfim_gs_energy_f64

    sweep(gs)
    _sync(gs.device)
    t0 = time.perf_counter()
    es = sweep(gs + 1e-3)[0]
    _sync(gs.device)
    dt = time.perf_counter() - t0
    err = es.double().cpu().numpy() - tfim_gs_energy_f64(np.linspace(g_min, g_max, n_points) + 1e-3)
    return {
        "opts_per_sec": n_points / dt,
        "seconds": dt,
        "median_error": float(np.median(err)),
        "max_error": float(np.max(err)),
        # signed: energies below exact flag an exploited environment readout
        "min_error": float(np.min(err)),
    }


@dataclasses.dataclass(frozen=True)
class GroundStateConfig:
    """Configs 1-2: the variational TFIM ground state at bond dimension D
    (``algorithms.find_ground_state``), timed once."""

    g: float = 1.0
    D: int = 2
    ansatz: str = "suN"
    method: str = "lbfgs"
    steps: int = 300
    device: str | None = None

    def run(self) -> dict:
        from .algorithms import find_ground_state
        from .ham import tfim_gs_energy_f64
        from .ham.hamiltonian import tfim

        dev = resolve_device(self.device)
        _sync(dev)
        t0 = time.perf_counter()
        res = find_ground_state(tfim(self.g), D=self.D, ansatz=self.ansatz, method=self.method, steps=self.steps,
                                device=dev)
        _sync(dev)
        dt = time.perf_counter() - t0
        e_exact = float(tfim_gs_energy_f64(self.g))
        return {"energy": res.energy, "exact": e_exact, "error": res.energy - e_exact, "seconds": dt,
                "steps_per_sec": self.steps / dt}


@dataclasses.dataclass(frozen=True)
class QuenchConfig:
    """Config 3: the quench pipeline (``algorithms.loschmidt_echo_run``)
    against the exact Loschmidt rate, timed once."""

    g0: float = 1.5
    g1: float = 0.2
    t_max: float = 0.8
    n_steps: int = 20
    inner_steps: int = 100
    device: str | None = None

    def run(self) -> dict:
        from .algorithms.evolve import loschmidt_echo_run
        from .ham import loschmidt_rate

        dev = resolve_device(self.device)
        _sync(dev)
        t0 = time.perf_counter()
        times, rates, _ = loschmidt_echo_run(self.g0, self.g1, self.t_max, self.n_steps,
                                             inner_steps=self.inner_steps, device=dev)
        _sync(dev)
        dt = time.perf_counter() - t0
        t = times.double().cpu().numpy()
        exact = np.array([float(loschmidt_rate(x, self.g0, self.g1)) for x in t])
        return {"max_rate_error": float(np.max(np.abs(rates.double().cpu().numpy() - exact))), "seconds": dt,
                "tdvp_steps_per_sec": self.n_steps / dt}


@dataclasses.dataclass(frozen=True)
class SweepConfig:
    """Config 4: the chart phase-diagram sweep
    (``parallel.sweep_ground_states``), ``n_points`` couplings timed on
    the shifted grid after one untimed call.

    ``use_mesh`` shards the points over every card (``parallel.make_mesh``)
    when there is more than one, and runs unsharded on one.  Whether that
    is faster is not measured: no run has had two cards, and on one card
    two shards (the card named twice) run 2.1-2.6x slower than unsharded,
    because their worker threads share the interpreter lock."""

    n_points: int = 256
    D: int = 2
    steps: int = 300
    g_min: float = 0.1
    g_max: float = 2.0
    use_mesh: bool = False
    ansatz: str = "suN"
    refine_passes: int = 0
    device: str | None = None

    def grid(self) -> torch.Tensor:
        return _grid(self.device, self.n_points, self.g_min, self.g_max)

    def sweep(self, gs: torch.Tensor):
        from .parallel import make_mesh, sweep_ground_states

        mesh = make_mesh() if self.use_mesh and torch.cuda.device_count() > 1 else None
        return sweep_ground_states(gs, D=self.D, ansatz=self.ansatz, steps=self.steps, mesh=mesh,
                                   refine_passes=self.refine_passes)

    def run(self) -> dict:
        return _sweep_metrics(self.sweep, self.grid(), self.n_points, self.g_min, self.g_max)


@dataclasses.dataclass(frozen=True)
class FusedSweepConfig:
    """Config 4 through the fused Riemannian engine
    (``parallel.sweep_ground_states_fused``, kernels K1-K3 on the card)."""

    n_points: int = 256
    steps: int = 300
    restarts: int = 4
    g_min: float = 0.1
    g_max: float = 2.0
    device: str | None = None

    def grid(self) -> torch.Tensor:
        return _grid(self.device, self.n_points, self.g_min, self.g_max)

    def sweep(self, gs: torch.Tensor):
        from .parallel import sweep_ground_states_fused

        return sweep_ground_states_fused(gs, steps=self.steps, restarts=self.restarts)

    def run(self) -> dict:
        return _sweep_metrics(self.sweep, self.grid(), self.n_points, self.g_min, self.g_max)


@dataclasses.dataclass(frozen=True)
class GrownSweepConfig:
    """Config 4 at large D by bond-growth continuation
    (``parallel.sweep_ground_states_grown``): the grid optimized up the
    ladder D_start -> ... -> D, each rung warm-started from the last."""

    n_points: int = 256
    D: int = 16
    steps: int = 300
    g_min: float = 0.1
    g_max: float = 2.0
    D_start: int = 2
    device: str | None = None

    def grid(self) -> torch.Tensor:
        return _grid(self.device, self.n_points, self.g_min, self.g_max)

    def sweep(self, gs: torch.Tensor):
        from .parallel import sweep_ground_states_grown

        return sweep_ground_states_grown(gs, D=self.D, steps=self.steps, D_start=self.D_start)

    def run(self) -> dict:
        return _sweep_metrics(self.sweep, self.grid(), self.n_points, self.g_min, self.g_max)


@dataclasses.dataclass(frozen=True)
class StiefelSweepConfig:
    """Config 4 at large D: the phase-diagram sweep by direct Stiefel
    descent on the (2D, D) isometry (``parallel.sweep.
    sweep_ground_states_stiefel``), ``n_points`` couplings in [g_min,
    g_max] in float32 on the card (float64 on the CPU), timed on the
    shifted grid g + 1e-3 after one untimed call (workloads.py:218-262).
    ``recycle_iters`` None rides the sweep's D-aware default (96 from
    D = 16).  ``precision`` and ``polish_steps`` are the sweep's two-phase
    schedule (bench.py's D = 32 row: 180 steps, "default", 60 polish).

    ``run()`` returns the JAX config's keys: the energies against
    ``tfim_gs_energy_f64`` as the sweep returns them."""

    n_points: int = 1024
    D: int = 16
    steps: int = 300
    g_min: float = 0.1
    g_max: float = 2.0
    recycle_iters: int | None = None
    precision: str | None = None
    polish_steps: int = 0
    device: str | None = None

    def grid(self) -> torch.Tensor:
        """The untimed call's couplings on the device (float32 on CUDA)."""
        return _grid(self.device, self.n_points, self.g_min, self.g_max)

    def sweep(self, gs: torch.Tensor):
        from .parallel.sweep import sweep_ground_states_stiefel

        return sweep_ground_states_stiefel(gs, D=self.D, steps=self.steps, recycle_iters=self.recycle_iters,
                                           precision=self.precision, polish_steps=self.polish_steps)

    def run(self) -> dict:
        return _sweep_metrics(self.sweep, self.grid(), self.n_points, self.g_min, self.g_max)


@dataclasses.dataclass(frozen=True)
class LargeDConfig:
    """Config 5's large-D leg: the Riemannian TFIM ground state at D = 64
    (``optim.riemann.ground_state_riemannian``, recycled environments; at
    n = D^2 = 4,096 > 1,024 the warm adjoint runs its GMRES branch), the
    start drawn from seed 1 (workloads.py:348-380)."""

    g: float = 1.0
    D: int = 64
    steps: int = 150
    device: str | None = None

    def run(self) -> dict:
        from .ham import tfim_gs_energy_f64
        from .ham.hamiltonian import tfim
        from .optim.riemann import ground_state_riemannian

        dev = resolve_device(self.device)
        h = tfim(self.g).to_matrix()
        _sync(dev)
        t0 = time.perf_counter()
        _, e, hist = ground_state_riemannian(h, D=self.D, steps=self.steps,
                                             generator=torch.Generator().manual_seed(1), device=dev)
        _sync(dev)
        dt = time.perf_counter() - t0
        hist = hist.double().cpu().numpy()
        if not np.all(np.isfinite(hist)):
            raise RuntimeError("LargeDConfig: non-finite energy history")
        e_exact = float(tfim_gs_energy_f64(self.g))
        # e is the returned state's energy (hist[-1]), never best-of-history
        return {"energy": e, "exact": e_exact, "error": e - e_exact, "best_seen": float(hist.min()),
                "seconds": dt, "steps_per_sec": self.steps / dt}


@dataclasses.dataclass(frozen=True)
class BrickworkConfig:
    """Config 5: gen-2 brickwork TDVP overlaps, B = ``batch`` random brick
    pairs, seeded numpy QR unitaries, Ml = M^dag, one shared random W
    (workloads.py:265-345).

    ``run()`` times ``iters`` calls of the flat form
    (``kernels.brickwork_fast.manifold_overlap_batched``) and, on the card,
    ``4 * iters`` calls of the fused kernel K6
    (``kernels.brickwork_pallas.manifold_overlap_pallas``), the headline;
    the two must agree on a sample of |overlap| to 1e-5 before and after
    the timed loops.  On the CPU only the flat row runs (the fused wrapper
    would run the same plain version)."""

    batch: int = 16384
    iters: int = 30
    device: str | None = None

    def inputs(self):
        """(U1, U2, U1p, U2p, M, Ml, W) complex64 on the device."""
        dev = resolve_device(self.device)
        rng = np.random.default_rng(0)

        def hu(b, n):
            A = rng.standard_normal((b, n, n)) + 1j * rng.standard_normal((b, n, n))
            Q, _ = np.linalg.qr(A)
            return torch.from_numpy(Q.astype(np.complex64)).to(dev)

        U1, U2, U1p, U2p = (hu(self.batch, 4) for _ in range(4))
        M = hu(self.batch, 2)
        W = hu(1, 16)[0]
        return U1, U2, U1p, U2p, M, M.mH.resolve_conj().contiguous(), W

    def run(self) -> dict:
        from .kernels.brickwork_fast import manifold_overlap_batched
        from .kernels.brickwork_pallas import manifold_overlap_pallas

        args = self.inputs()
        dev = args[0].device

        def sync():
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)

        def timed(fn, n):
            out = fn(*args).abs()
            sync()
            t0 = time.perf_counter()
            for _ in range(n):
                out = fn(*args).abs()
            sync()
            return out, time.perf_counter() - t0

        ref = manifold_overlap_batched(*args).abs()[:16]
        out, dt = timed(manifold_overlap_batched, self.iters)
        if not bool(torch.isfinite(out[:4]).all()):
            raise RuntimeError("BrickworkConfig: non-finite flat-form overlaps")
        metrics = {"overlap_evals_per_sec": self.batch * self.iters / dt, "seconds": dt,
                   "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"}
        if dev.type == "cuda":
            first = manifold_overlap_pallas(*args).abs()
            err_before = (first[:16] - ref).abs().max().item()
            out2, dt2 = timed(manifold_overlap_pallas, self.iters * 4)
            err_after = (out2[:16] - ref).abs().max().item()
            if not (err_before < 1e-5 and err_after < 1e-5):
                raise RuntimeError(f"BrickworkConfig: fused and flat forms disagree "
                                   f"({err_before:.3g} before, {err_after:.3g} after the timed loop)")
            metrics.update(overlap_evals_per_sec_fused=self.batch * self.iters * 4 / dt2,
                           seconds_fused=dt2, max_abs_diff=max(err_before, err_after))
        return metrics


@dataclasses.dataclass(frozen=True)
class DeepBrickworkConfig:
    """Config 5's brick-wall leg: the deep-brickwork TFIM ground state at
    D = 32-64 (``algorithms.ground_state_deep_brickwork``, the recycled
    environments), the start drawn from seed 1, timed once."""

    g: float = 1.0
    D: int = 32
    steps: int = 300
    depth: int | None = None
    device: str | None = None

    def run(self) -> dict:
        from .algorithms import ground_state_deep_brickwork
        from .ham import tfim_gs_energy_f64
        from .ham.hamiltonian import tfim

        dev = resolve_device(self.device)
        _sync(dev)
        t0 = time.perf_counter()
        gs = ground_state_deep_brickwork(tfim(self.g), D=self.D, depth=self.depth, steps=self.steps,
                                         generator=torch.Generator().manual_seed(1), device=dev)
        _sync(dev)
        dt = time.perf_counter() - t0
        if not bool(torch.isfinite(gs.history).all()):
            raise RuntimeError("DeepBrickworkConfig: non-finite energy history")
        e_exact = float(tfim_gs_energy_f64(self.g))
        return {"energy": gs.energy, "exact": e_exact, "error": gs.energy - e_exact,
                "n_params": gs.params.numel(), "seconds": dt, "steps_per_sec": self.steps / dt}


CONFIG_LADDER = (
    GroundStateConfig(D=2),
    GroundStateConfig(D=4),
    QuenchConfig(),
    SweepConfig(),
    FusedSweepConfig(),
    # config 4 at large D through the brick-wall ansatz, four refine passes
    SweepConfig(n_points=1024, D=16, ansatz="deep_bw", refine_passes=4),
    GrownSweepConfig(),
    StiefelSweepConfig(),
    BrickworkConfig(),
    LargeDConfig(D=32),
    LargeDConfig(D=64),
    DeepBrickworkConfig(D=32),
)


def run_ladder(configs: Sequence = CONFIG_LADDER, profile_dir: Optional[str] = None) -> dict:
    """Run the workload ladder; returns {config_name: metrics}, config_name
    = ``<ConfigClass>_<i>``.  With ``profile_dir`` (or QMPS_PROFILE_DIR in
    the environment) each config runs under ``utils.profiling.trace``,
    its Chrome trace written to ``<profile_dir>/<config_name>/trace.json``."""
    import os

    from .utils.profiling import trace

    profile_dir = profile_dir or os.environ.get("QMPS_PROFILE_DIR")
    results = {}
    for i, cfg in enumerate(configs):
        name = f"{type(cfg).__name__}_{i}"
        if profile_dir:
            with trace(os.path.join(profile_dir, name)):
                results[name] = cfg.run()
        else:
            results[name] = cfg.run()
    return results


if __name__ == "__main__":
    import json

    print(json.dumps(run_ladder(), indent=1, default=float))
