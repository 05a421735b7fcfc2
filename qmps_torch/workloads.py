"""The benchmark configuration ladder as runnable workloads (counterpart
of ``qmps_tpu.workloads``).

Ported: config 5, ``BrickworkConfig``, the gen-2 brickwork overlap
throughput; config 4 at large D, ``StiefelSweepConfig``; config 5's
large-D leg, ``LargeDConfig``.  The other configurations wait
(ROADMAP.md, "The rest").
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from .config import FAST_RDTYPE, resolve_device


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


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
        dev = resolve_device(self.device)
        dtype = FAST_RDTYPE if dev.type == "cuda" else torch.float64
        return torch.linspace(self.g_min, self.g_max, self.n_points, dtype=torch.float64).to(dev, dtype)

    def sweep(self, gs: torch.Tensor):
        from .parallel.sweep import sweep_ground_states_stiefel

        return sweep_ground_states_stiefel(gs, D=self.D, steps=self.steps, recycle_iters=self.recycle_iters,
                                           precision=self.precision, polish_steps=self.polish_steps)

    def run(self) -> dict:
        from .ham import tfim_gs_energy_f64

        gs = self.grid()
        self.sweep(gs)
        _sync(gs.device)
        t0 = time.perf_counter()
        es, _, _ = self.sweep(gs + 1e-3)
        _sync(gs.device)
        dt = time.perf_counter() - t0
        exact = tfim_gs_energy_f64(np.linspace(self.g_min, self.g_max, self.n_points) + 1e-3)
        err = es.double().cpu().numpy() - exact
        return {
            "opts_per_sec": self.n_points / dt,
            "seconds": dt,
            "median_error": float(np.median(err)),
            "max_error": float(np.max(err)),
            # signed: energies below exact flag an exploited environment readout
            "min_error": float(np.min(err)),
        }


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
