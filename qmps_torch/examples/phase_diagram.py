"""The TFIM phase diagram as one batched sweep: the suN chart sweep with a
refine pass, the fused Riemannian engine and the grown D = 4 ladder
(examples/phase_diagram.py of the JAX package; one card, no mesh).

Run:  python -m qmps_torch.examples.phase_diagram [--cpu]
"""
import time

import numpy as np
import torch

from qmps_torch.config import resolve_device
from qmps_torch.examples import cli_device
from qmps_torch.ham import tfim_gs_energy
from qmps_torch.parallel import sweep_ground_states, sweep_ground_states_fused, sweep_ground_states_grown


def _timed(fn):
    t0 = time.perf_counter()
    es, _ = fn()
    if es.is_cuda:
        torch.cuda.synchronize()
    return es.cpu().numpy(), time.perf_counter() - t0


def main(device=None):
    dev = resolve_device(device)
    n_points = 64
    gs = torch.linspace(0.1, 2.0, n_points, dtype=torch.float64)
    exact = tfim_gs_energy(gs).numpy()
    # refine_passes=1: adiabatic-continuation re-optimization from each
    # point's neighbours (removes the occasional bad-basin outlier)
    es, dt = _timed(lambda: sweep_ground_states(gs, D=2, steps=300, refine_passes=1, device=dev))
    err = es - exact
    print(f"{n_points} ground states in {dt:.2f}s ({n_points / dt:.1f} opts/s)")
    print(f"max error vs exact integral: {err.max():.2e}; all above exact: {bool((err > -1e-8).all())}")

    # the fused Riemannian engine: the same physics, the energy objective's
    # kernels on the card
    es_f, dt_f = _timed(lambda: sweep_ground_states_fused(gs, steps=300, restarts=2, device=dev))
    err_f = es_f - exact
    print(f"fused engine: {dt_f:.2f}s ({n_points / dt_f:.1f} opts/s), max error {err_f.max():.2e}")

    # bond growth to D = 4: every point warm-starts from its own D = 2 optimum
    # through the exact su(N) embedding
    es_g, dt_g = _timed(lambda: sweep_ground_states_grown(gs, D=4, steps=300, device=dev))
    err_g = es_g - exact
    print(f"grown D=4 ladder: {dt_g:.2f}s, max error {err_g.max():.2e} (D=2 sweep above: {err.max():.2e})")
    return {"suN_max_error": float(err.max()), "fused_max_error": float(err_f.max()),
            "grown_max_error": float(err_g.max())}


if __name__ == "__main__":
    main(cli_device())
