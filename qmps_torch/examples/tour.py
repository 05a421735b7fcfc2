"""Guided tour: represent -> optimize -> evolve (the qmps.ipynb walkthrough;
examples/tour.py of the JAX package).

Run:  python -m qmps_torch.examples.tour [--cpu]
"""
import numpy as np
import torch

from qmps_torch.algorithms import MPSTimeEvolve, RepresentMPS, find_ground_state
from qmps_torch.config import default_dtypes, resolve_device
from qmps_torch.core.linalg import random_unitary
from qmps_torch.env.variational import tomography_env_objective
from qmps_torch.examples import cli_device
from qmps_torch.ham import tfim, tfim_gs_energy


def main(device=None):
    dev = resolve_device(device)
    cdtype, _ = default_dtypes(dev)
    print("== 1. Represent: the environment of a state unitary ==")
    U = random_unitary(torch.Generator().manual_seed(0), 4, dtype=cdtype, device=dev)
    mismatch = {}
    for strategy in ("exact", "variational", "power"):
        V = RepresentMPS(U, strategy).get_env()
        mismatch[strategy] = float(tomography_env_objective(U, V))
        print(f"   {strategy:12s}: tomography mismatch {mismatch[strategy]:.2e}")

    print("== 2. Optimize: TFIM ground state at criticality ==")
    e = float(tfim_gs_energy(1.0))
    errors = {}
    for D in (2, 4):
        res = find_ground_state(tfim(1.0), D=D, method="lbfgs", steps=250, device=dev)
        errors[D] = res.energy - e
        print(f"   D={D}: E = {res.energy:.8f}  (exact {e:.8f}, err {errors[D]:.2e})")

    print("== 3. Evolve: TDVP stationarity of the ground state ==")
    gs = find_ground_state(tfim(1.0), D=2, ansatz="full15", method="lbfgs", steps=250, device=dev)
    rec = MPSTimeEvolve(tfim(1.0), dt=0.02, inner_steps=80).evolve(gs.params, 5)
    echo = rec.loschmidt.cpu().numpy()
    print("   |<psi_0|psi_t>|^2 per site:", np.round(echo, 6))
    return {"tomography_mismatch": mismatch, "energy_errors": errors, "loschmidt_min": float(echo.min())}


if __name__ == "__main__":
    main(cli_device())
