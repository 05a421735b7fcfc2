"""The TFIM quench 1.5 -> 0.2: the exact rate function against classical
TDVP at D = 8 and circuit TDVP at D = 2 (examples/loschmidt_quench.py of
the JAX package).

Run:  python -m qmps_torch.examples.loschmidt_quench [--cpu]
"""
import numpy as np
import torch

from qmps_torch.algorithms import find_ground_state
from qmps_torch.algorithms.evolve import loschmidt_echo_run
from qmps_torch.config import resolve_device
from qmps_torch.examples import cli_device
from qmps_torch.ham import loschmidt_rate, tfim
from qmps_torch.mps.tdvp import Trajectory

G0, G1, T_MAX = 1.5, 0.2, 1.6


def main(device=None):
    dev = resolve_device(device)
    print("== exact rate function ==")
    ts = np.linspace(0.1, T_MAX, 8)
    exact = [float(loschmidt_rate(t, G0, G1)) for t in ts]

    print("== classical TDVP, D=8 ==")
    gs = find_ground_state(tfim(G0), D=8, ansatz="suN", method="lbfgs", steps=400, device=dev)
    # rk4int: explicit Euler at this dt stalls at the first dynamical phase
    # transition (Schmidt degeneracy); RK4 tracks straight through it
    traj = Trajectory(gs.A, tfim(G1).to_matrix()).rk4int(T_MAX, 400)
    rates_c = -np.log(traj.loschmidts().cpu().numpy())
    tc = np.linspace(T_MAX / 400, T_MAX, 400)

    print("== circuit TDVP, D=2 ==")
    tq, rates_q, _ = loschmidt_echo_run(G0, G1, T_MAX, 40, inner_steps=100, device=dev)
    tq, rates_q = torch.as_tensor(tq).cpu().numpy(), rates_q.cpu().numpy()

    print(f"{'t':>6} {'exact':>9} {'classical':>10} {'circuit':>9}")
    err_c, err_q = [], []
    for t, e in zip(ts, exact):
        ic, iq = np.argmin(np.abs(tc - t)), np.argmin(np.abs(tq - t))
        err_c.append(abs(rates_c[ic] - e))
        err_q.append(abs(rates_q[iq] - e))
        print(f"{t:6.2f} {e:9.5f} {rates_c[ic]:10.5f} {float(rates_q[iq]):9.5f}")
    return {"classical_max_error": float(max(err_c)), "circuit_max_error": float(max(err_q))}


if __name__ == "__main__":
    main(cli_device())
