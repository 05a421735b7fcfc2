"""PXP many-body scars: quantum against classical TDVP and a Poincare
section (scars.py + poincare_map/2body_scars.py; examples/scars_poincare.py
of the JAX package, joblib replaced by one batched computation).

Run:  python -m qmps_torch.examples.scars_poincare [--cpu]
"""
import math

import numpy as np
import torch

from qmps_torch.algorithms.scars import (
    ScarsEvolver,
    classical_poincare_sweep,
    classical_trajectory,
    poincare_sections,
)
from qmps_torch.config import resolve_device
from qmps_torch.examples import cli_device

MU = 0.325


def main(device=None):
    dev = resolve_device(device)
    p0 = torch.tensor([0.6, 0.9, 1.1, 0.4], dtype=torch.float64, device=dev)

    print("== quantum TDVP vs classical ODEs (short horizon) ==")
    dt, steps = 0.05, 10
    ev = ScarsEvolver(MU, dt, inner_steps=200, lr=1e-2)
    q = ev.simulate(p0, steps).cpu().numpy()
    c = np.mod(classical_trajectory(p0, torch.arange(steps, dtype=torch.float64, device=dev) * dt, MU).cpu().numpy(),
               2 * np.pi)
    dev_max = np.abs(np.angle(np.exp(1j * (q - c)))).max()
    print("   max angle deviation:", dev_max)

    print("== classical Poincare sections (batched ensemble) ==")
    u = torch.rand(16, 4, generator=torch.Generator().manual_seed(0), dtype=torch.float64)
    y0s = (0.2 + 1.8 * u).to(dev)
    trajs = classical_poincare_sweep(y0s, torch.linspace(0, 60, 2000, dtype=torch.float64, device=dev), MU)
    secs = poincare_sections(torch.remainder(trajs, 2 * math.pi))
    print("   crossings per trajectory:", [len(s) for s in secs])
    return {"max_angle_deviation": float(dev_max), "crossings": [len(s) for s in secs]}


if __name__ == "__main__":
    main(cli_device())
