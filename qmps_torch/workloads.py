"""The benchmark configuration ladder as runnable workloads (counterpart
of ``qmps_tpu.workloads``).

Ported: config 5, ``BrickworkConfig``, the gen-2 brickwork overlap
throughput.  The other configurations wait (ROADMAP.md, "The rest").
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from .config import resolve_device


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
