"""Finite-entanglement scaling at criticality: extract the central charge
(examples/central_charge.py of the JAX package).

At the TFIM critical point (g = 1) an iMPS at bond dimension D realizes an
effective correlation length xi(D) and half-chain entropy S(D), tied by
S = (c / 6) log xi + const (c = 1/2 for the Ising CFT; Tagliacozzo et al.,
PRB 78, 024410; Pollmann et al., PRL 102, 255701).  Each row is a VUMPS
solve warm-started by embedding the previous D's solution.  Runs in
complex128 (on the card too): float32 resolves the entanglement tail only
up to xi ~ 34.

Run:  python -m qmps_torch.examples.central_charge [--cpu]
"""
import time

import numpy as np
import torch

from qmps_torch.config import resolve_device
from qmps_torch.examples import cli_device
from qmps_torch.ham import sublattice_rotate, tfim, tfim_gs_energy, xy
from qmps_torch.ham.exact import xy_gs_energy
from qmps_torch.mps.imps import iMPS
from qmps_torch.mps.tdvp import vumps_ground_state


def grow(AL: torch.Tensor, D_new: int, generator: torch.Generator, eps: float = 1e-3) -> torch.Tensor:
    """Embed a (d, D, D) tensor in the corner of a (d, D_new, D_new) one,
    plus eps complex-normal noise so the new directions are optimizable
    (the D -> 2D warm start of scripts/bond_dimension.py, tensor-side)."""
    d, D, _ = AL.shape
    out = torch.zeros((d, D_new, D_new), dtype=AL.dtype, device=AL.device)
    out[:, :D, :D] = AL
    x = torch.randn(2, d, D_new, D_new, generator=generator, dtype=torch.float64)
    return out + eps * torch.complex(x[0], x[1]).to(AL.device, AL.dtype)


def scaling_table(Ds=(4, 8, 12, 16), iters=300, g=1.0, generator=None, h=None, e_exact=None, device=None):
    """[(D, energy_error, S, xi, seconds)] rows at a critical point: the
    critical TFIM by default, or an explicit two-site ``h`` with its exact
    energy."""
    dev = resolve_device(device)
    if h is None:
        h, e_exact = tfim(g).to_matrix(), float(tfim_gs_energy(g))
    else:
        e_exact = 0.0 if e_exact is None else float(e_exact)
    h = torch.as_tensor(np.asarray(h), dtype=torch.complex128, device=dev)
    generator = torch.Generator().manual_seed(7) if generator is None else generator
    rows, prev = [], None
    for D in Ds:
        t0 = time.perf_counter()
        A0 = None if prev is None else grow(prev, D, generator)
        AL, C, e, info = vumps_ground_state(h, D, iters=iters, k=32, A0=A0, device=dev)
        st = iMPS([AL])
        rows.append((D, e - e_exact, float(st.entanglement_entropy()), float(st.correlation_length()),
                     time.perf_counter() - t0))
        prev = AL
    return rows


def fit_central_charge(rows):
    """Least-squares slope of S against log xi, times 6."""
    S = np.array([r[2] for r in rows])
    xi = np.array([r[3] for r in rows])
    return 6.0 * np.polyfit(np.log(xi), S, 1)[0]


def main(device=None):
    dev = resolve_device(device)
    rows = scaling_table(Ds=(4, 8, 12, 16), device=dev)
    print(f"{'D':>3} {'e_err':>10} {'S':>8} {'xi':>9} {'s':>7}")
    for D, err, S, xi, dt in rows:
        print(f"{D:>3} {err:>10.2e} {S:>8.4f} {xi:>9.3f} {dt:>7.1f}")
    c = fit_central_charge(rows)
    print(f"fitted central charge c = {c:.3f}   (Ising CFT: 0.5)")
    # second CFT: the critical XY chain (free compact boson, c = 1); the D = 4
    # row is left out (XY's near-degenerate finite-D optima make it basin-fragile)
    rows_xy = scaling_table(Ds=(8, 12, 16), iters=400, h=sublattice_rotate(xy()), e_exact=xy_gs_energy(), device=dev)
    c_xy = fit_central_charge(rows_xy)
    print(f"XY chain: c = {c_xy:.3f}   (exact: 1)")
    return {"c_ising": float(c), "c_xy": float(c_xy)}


if __name__ == "__main__":
    main(cli_device())
