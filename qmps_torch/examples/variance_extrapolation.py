"""Energy-variance extrapolation: E(D) against sigma^2(D) from VUMPS at
the critical point, extrapolated to zero variance
(examples/variance_extrapolation.py of the JAX package).  Runs in
complex128.

Run:  python -m qmps_torch.examples.variance_extrapolation [--cpu]
"""
import numpy as np
import torch

from qmps_torch.config import resolve_device
from qmps_torch.examples import cli_device
from qmps_torch.ham import tfim, tfim_gs_energy
from qmps_torch.mps.tdvp import energy_variance_density, vumps_ground_state


def ladder(g: float, Ds=(2, 3, 4, 6, 8), iters: int = 300, device=None):
    """(D, E_D, sigma^2_D, |grad|) rows from VUMPS-converged states."""
    h = torch.as_tensor(tfim(g).to_matrix(), dtype=torch.complex128, device=device)
    rows = []
    for D in Ds:
        AL, C, e, info = vumps_ground_state(h, D=D, iters=iters, generator=torch.Generator().manual_seed(D),
                                            device=device)
        r = C @ C.mH
        r = r / r.diagonal().sum()
        var = float(energy_variance_density(AL, r, h))
        rows.append((D, float(e), var, float(info["grad_norms"][-1])))
    return rows


def extrapolate(rows):
    """Linear fit E = E0 + a sigma^2 through the ladder, weighted toward the
    small-variance end (the asymptotic regime)."""
    v = np.array([r[2] for r in rows])
    e = np.array([r[1] for r in rows])
    w = 1.0 / np.maximum(v, 1e-14)
    A = np.stack([np.ones_like(v), v], axis=1)
    coef, *_ = np.linalg.lstsq(A * w[:, None], e * w, rcond=None)
    return coef[0], coef[1]


def main(device=None):
    dev = resolve_device(device)
    g = 1.0  # the critical point: slowest D-convergence
    e_exact = float(tfim_gs_energy(g))
    rows = ladder(g, device=dev)
    print(f"TFIM g={g}  exact E0 = {e_exact:.10f}")
    print(f"{'D':>3} {'energy':>15} {'error':>10} {'sigma^2':>10} {'|grad|':>9}")
    for D, e, var, gn in rows:
        print(f"{D:>3} {e:>15.10f} {e - e_exact:>10.2e} {var:>10.2e} {gn:>9.1e}")
    e0, slope = extrapolate(rows)
    best = rows[-1][1]
    print(f"\nlinear fit E(sigma^2): intercept {e0:.10f}, slope {slope:+.3f}")
    print(f"largest-D error:      {best - e_exact:+.2e}")
    print(f"extrapolated error:   {e0 - e_exact:+.2e}  "
          f"({abs(best - e_exact) / max(abs(e0 - e_exact), 1e-16):.0f}x closer)")
    assert abs(e0 - e_exact) < abs(best - e_exact), "extrapolation must help"
    return {"largest_D_error": best - e_exact, "extrapolated_error": float(e0 - e_exact)}


if __name__ == "__main__":
    main(cli_device())
