"""Entanglement growth after a quench: S(t) of classical TDVP at D = 8
from the g = 1.5 ground state under g = 0.2 (examples/entanglement_growth.py
of the JAX package).

Run:  python -m qmps_torch.examples.entanglement_growth [--cpu]
"""
import numpy as np

from qmps_torch.algorithms import find_ground_state
from qmps_torch.config import resolve_device
from qmps_torch.examples import cli_device
from qmps_torch.ham import tfim
from qmps_torch.mps.imps import iMPS
from qmps_torch.mps.tdvp import Trajectory

D, T_MAX, N_STEPS = 8, 3.0, 300


def main(device=None):
    dev = resolve_device(device)
    gs = find_ground_state(tfim(1.5), D=D, ansatz="suN", method="lbfgs", steps=400, device=dev)
    S0 = float(iMPS([gs.A]).entanglement_entropy())
    print(f"ground state at g=1.5, D={D}: S0 = {S0:.4f}")
    traj = Trajectory(gs.A, tfim(0.2).to_matrix()).rk4int(T_MAX, N_STEPS)
    ceiling = np.log(D)
    print(f"{'t':>5} {'S(t)':>8}   ceiling log(D) = {ceiling:.3f}")
    S_t = []
    for t in np.linspace(0.0, T_MAX, 13):
        k = min(int(round(t / T_MAX * N_STEPS)), N_STEPS)
        S = float(iMPS([traj.ALs[k]]).entanglement_entropy())
        S_t.append(S)
        print(f"{t:>5.2f} {S:>8.4f}   {'#' * int(40 * S / ceiling)}")
    return {"S0": S0, "S_final": S_t[-1]}


if __name__ == "__main__":
    main(cli_device())
