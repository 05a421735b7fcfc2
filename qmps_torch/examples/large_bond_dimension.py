"""Large bond dimension: Riemannian ground states at the critical point
for D up to 64 (examples/large_bond_dimension.py of the JAX package,
whose TPU branch runs D = 4-64 and whose CPU branch D = 4-16).

Run:  python -m qmps_torch.examples.large_bond_dimension [--cpu]
"""
import time

import numpy as np
import torch

from qmps_torch.config import resolve_device
from qmps_torch.examples import cli_device
from qmps_torch.ham import tfim, tfim_gs_energy
from qmps_torch.optim.riemann import ground_state_riemannian


def main(device=None):
    dev = resolve_device(device)
    h = tfim(1.0).to_matrix()  # the critical point: hardest for small D
    e_exact = float(tfim_gs_energy(1.0))
    Ds = (4, 8, 16, 32, 64) if dev.type == "cuda" else (4, 8, 16)
    print(f"device={dev}  exact E0 = {e_exact:.8f}")
    print(f"{'D':>3} {'energy':>12} {'error':>10} {'s':>8}")
    out = {}
    for D in Ds:
        t0 = time.perf_counter()
        _, e, hist = ground_state_riemannian(h, D=D, steps=250, generator=torch.Generator().manual_seed(1),
                                             device=dev)
        dt = time.perf_counter() - t0
        assert bool(torch.isfinite(torch.as_tensor(hist)).all())
        # e is the returned state's energy
        out[D] = e - e_exact
        print(f"{D:>3} {e:>12.8f} {e - e_exact:>10.2e} {dt:>8.1f}")
    return out


if __name__ == "__main__":
    main(cli_device())
