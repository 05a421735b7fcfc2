"""Gen-2 environment sensitivity studies: the eta(dt) fit and the M-ansatz
parameter stiffness spectrum (examples/env_sensitivity.py of the JAX
package; new_tdvp/RightEnvParametrisation.py and
EnvironmentParamSensitivity.py of the reference).

- |eta| of the converged brickwork TDVP step at each dt, with the window
  gate W (the per-site step fidelity the stepper maximizes) and without
  it (the raw state motion); 1 - |eta| = c2 dt^2 + c3 dt^3 by least
  squares, and the reference's bound eta >= 1 - 5 dt^2 checked.
- The exact Hessian of the represent residual |eta M(p) - E[M(p)]|_F^2 at
  the variational optimum: stiff directions against sloppy (gauge) ones.

Runs in complex128 (the brickwork entry points take h's precision).

Run:  python -m qmps_torch.examples.env_sensitivity [--cpu]
"""
import math

import numpy as np
import torch

from qmps_torch.algorithms.brickwork_tdvp import evolve_cost_eig, optimize_brickwork, quench_window_gate
from qmps_torch.circuits.brickwork import env_M, exact_right_env, param_bricks, right_env_map
from qmps_torch.config import resolve_device
from qmps_torch.env.variational import represent_variational_M
from qmps_torch.examples import cli_device
from qmps_torch.ham import tfim
from qmps_torch.optim.minimize import adam_steps


def tdvp_step(params, W, inner_steps: int = 250, lr: float = 2e-2):
    """One warm-started TDVP step: adam from params on evolve_cost_eig."""
    p, _ = adam_steps(lambda p: evolve_cost_eig(p, params, W), params, inner_steps, lr)
    return p


def eta_dt_study(p_gs, g_quench: float, dts):
    """|eta|(dt) of the converged TDVP step, with and without W."""
    h1 = tfim(g_quench).to_matrix()
    rows = []
    for dt in dts:
        W = torch.as_tensor(quench_window_gate(h1, float(dt))).to(p_gs.device)
        p_new = tdvp_step(p_gs, W)
        with torch.no_grad():
            eta_W = float(torch.sqrt(-evolve_cost_eig(p_new, p_gs, W)))
            U1, U2 = param_bricks(p_gs)
            U1p, U2p = param_bricks(p_new)
            eta_mixed, _ = exact_right_env(U1, U2, U1p.mH, U2p.mH)
        rows.append((float(dt), eta_W, float(eta_mixed.abs())))
    return rows


def fit_eta_poly(rows, col: int):
    """Least-squares 1 - |eta| = c2 dt^2 + c3 dt^3 (the reference's fit)."""
    dt = np.array([r[0] for r in rows])
    y = 1.0 - np.array([r[col] for r in rows])
    A = np.stack([dt**2, dt**3], axis=1)
    (c2, c3), *_ = np.linalg.lstsq(A, y, rcond=None)
    return float(c2), float(c3), float(np.max(np.abs(A @ np.array([c2, c3]) - y)))


def m_param_stiffness(p_gs):
    """Hessian spectrum of the represent residual at the variational
    optimum, in the (eta, p6) chart (EnvironmentParamSensitivity.py, exact
    derivatives)."""
    U1, U2 = param_bricks(p_gs.detach())
    U1d, U2d = U1.mH, U2.mH
    eta, M, res = represent_variational_M(U1, U2, U1d, U2d, steps=800)

    def loss(x):
        e, p = x[0], x[1:]
        Mp = env_M(p)
        EM = right_env_map(U1, U2, U1d, U2d, Mp)
        return ((e * Mp - EM).abs() ** 2).sum()

    x0 = torch.tensor([float(eta.real), math.pi / 4, 0, 0, 0, 0, 0], dtype=p_gs.dtype, device=p_gs.device)
    x, _ = adam_steps(loss, x0, 1500, 2e-2)
    H = torch.autograd.functional.hessian(loss, x).cpu().numpy()
    return float(loss(x)), np.linalg.eigvalsh(H), float(eta.abs()), float(res)


def main(device=None):
    dev = resolve_device(device)
    g0, g1 = 1.5, 0.2  # the reference's production quench
    h0 = torch.as_tensor(tfim(g0).to_matrix(), dtype=torch.complex128, device=dev)
    res = optimize_brickwork(h0, steps=500, method="adam", device=dev)
    p_gs = res.x
    print(f"brickwork ground state at g={g0}: E = {float(res.fun):+.6f}")

    dts = np.array([0.005, 0.01, 0.02, 0.03, 0.05, 0.08, 0.12])
    rows = eta_dt_study(p_gs, g1, dts)
    print("\n   dt      |eta_W|       |eta_mixed|")
    for dt, eW, eM in rows:
        print(f"  {dt:5.3f}   {eW:.8f}   {eM:.8f}")
    c2W, c3W, rW = fit_eta_poly(rows, 1)
    c2M, c3M, rM = fit_eta_poly(rows, 2)
    print(f"\nfit 1-|eta_W|     = {c2W:+.3f} dt^2 {c3W:+.3f} dt^3  (max resid {rW:.1e})")
    print(f"fit 1-|eta_mixed| = {c2M:+.3f} dt^2 {c3M:+.3f} dt^3  (max resid {rM:.1e})")
    bound_ok = all(1 - 5 * dt * dt <= eM + 1e-12 for dt, _, eM in rows)
    print(f"reference bound eta >= 1 - 5 dt^2 holds on the grid: {bound_ok}")

    loss_opt, evals, eta_self, res_self = m_param_stiffness(p_gs)
    print(f"\nself-environment represent: |eta| = {eta_self:.6f}, residual {res_self:.2e}")
    print("M-chart Hessian eigenvalues at the optimum (stiff -> sloppy):")
    print("  " + "  ".join(f"{v:+.3e}" for v in evals[::-1]))
    n_sloppy = int(np.sum(np.abs(evals) < 1e-3 * np.max(np.abs(evals))))
    print(f"sloppy (gauge) directions: {n_sloppy} of {len(evals)}")

    assert bound_ok, "eta(dt) violated the reference's 1-5dt^2 bound"
    assert c2M < 5.0, f"mixed-eta curvature {c2M} exceeds the bound constant"
    print("\nenv sensitivity study OK")
    return {"c2_W": c2W, "c2_mixed": c2M, "sloppy": n_sloppy}


if __name__ == "__main__":
    main(cli_device())
