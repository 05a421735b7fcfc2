"""Noisy Loschmidt echoes: the TFIM quench 1.5 -> 0.2 under depolarizing
noise of three strengths (examples/noisy_loschmidt.py of the JAX package).

Run:  python -m qmps_torch.examples.noisy_loschmidt [--cpu]
"""
import numpy as np
import torch

from qmps_torch.algorithms.evolve import noisy_loschmidt_echo_run
from qmps_torch.config import resolve_device
from qmps_torch.examples import cli_device
from qmps_torch.ham import loschmidt_rate


def main(device=None):
    dev = resolve_device(device)
    noises = [0.0, 1e-3, 5e-3]
    times, rates = noisy_loschmidt_echo_run(g0=1.5, g1=0.2, t_max=0.5, n_steps=10, noise_levels=noises,
                                            inner_steps=60, gs_steps=200, device=dev)
    times, R = torch.as_tensor(times).cpu().numpy(), rates.cpu().numpy()
    exact = np.array([float(loschmidt_rate(t, 1.5, 0.2)) for t in times])
    print(f"{'t':>6} {'exact':>8} " + " ".join(f"p={p:<7g}" for p in noises))
    for i, t in enumerate(times):
        print(f"{t:6.2f} {exact[i]:8.4f} " + " ".join(f"{R[j, i]:9.4f}" for j in range(len(noises))))
    return {"noiseless_max_error": float(np.abs(R[0] - exact).max())}


if __name__ == "__main__":
    main(cli_device())
