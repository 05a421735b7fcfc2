"""The TFIM's one-particle dispersion from the excitation ansatz, and the
spectral weights of the order operator (examples/dispersion.py of the JAX
package).  Runs in complex128.

Run:  python -m qmps_torch.examples.dispersion [--cpu]
"""
import numpy as np
import torch

from qmps_torch.config import resolve_device
from qmps_torch.core.paulis import Z
from qmps_torch.examples import cli_device
from qmps_torch.ham import tfim
from qmps_torch.mps import spectral_weights, vumps_ground_state
from qmps_torch.mps.excitations import dispersion
from qmps_torch.mps.tdvp import mixed_gauge


def main(device=None):
    dev = resolve_device(device)
    g, D = 1.5, 8
    h = torch.as_tensor(tfim(g).to_matrix(), dtype=torch.complex128, device=dev)
    ps = np.linspace(0.0, np.pi, 13)
    om = dispersion(h, D=D, ps=ps, n_levels=1, device=dev)
    exact = 2.0 * np.sqrt(1.0 + g * g - 2.0 * g * np.cos(ps))
    print(f"TFIM g={g}, D={D}  (gap at k=0: exact 2|g-1| = {2 * abs(g - 1):.3f})")
    print(f"{'k':>7} {'omega(k)':>12} {'exact':>12} {'delta':>10}")
    for p, w, e in zip(ps, om[:, 0], exact):
        print(f"{p:>7.4f} {w:>12.8f} {e:>12.8f} {w - e:>10.2e}")

    # spectral weights: the delta-peak strengths of the order operator Z;
    # the one-particle band saturates the static structure factor to ~99%
    # in the paramagnetic phase
    AL, C, _, _ = vumps_ground_state(h, D, iters=250, k=32, device=dev)
    gs = mixed_gauge(AL)
    Zd = Z.to(dev)
    print(f"\n{'k':>7} {'omega_0':>10} {'weight |<Phi|Z_k|0>|^2':>22}")
    weights = {}
    for p in (0.5, 1.5, 2.5):
        omw, wt = spectral_weights(*gs, h, Zd, p, n_levels=1)
        weights[p] = float(wt[0])
        print(f"{p:>7.4f} {omw[0]:>10.6f} {wt[0]:>22.6f}")
    return {"max_dispersion_error": float(np.abs(om[:, 0] - exact).max()), "weights": weights}


if __name__ == "__main__":
    main(cli_device())
