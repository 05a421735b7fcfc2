"""Neel quench under the Heisenberg chain: cell-blocked TDVP against exact
diagonalization (examples/neel_quench.py of the JAX package).

The Neel product state |up down up down ...> evolves under H = sum (XX +
YY + ZZ); the staggered magnetization m_s(t) relaxes through a sign change
and revival (Barmettler et al., PRL 102, 130603).  The single-site TDVP
runs on blocked d = 4 cells (``ham.block_two_site``), validated by RK4 on
the full state of an L = 14 ring.  The product start is padded with eps
noise (an exactly rank-1 center matrix sits at the TDVP pseudo-inverse
cutoff).  Runs in complex128.

Run:  python -m qmps_torch.examples.neel_quench [--cpu]
"""
import numpy as np
import torch

from qmps_torch.config import resolve_device
from qmps_torch.examples import cli_device
from qmps_torch.ham import block_two_site, heisenberg
from qmps_torch.mps import iMPS
from qmps_torch.mps.tdvp import Trajectory


def ed_staggered(h2, L=14, T=0.8, n=800, n_report=9):
    """m_s(t) of the Neel quench by RK4 on the full 2^L state vector (host
    numpy, the JAX example's)."""
    h4 = np.asarray(h2, float).reshape(2, 2, 2, 2)
    bonds = [(i, i + 1) for i in range(L - 1)] + [(L - 1, 0)]

    def Hv(v):
        psi = v.reshape((2,) * L)
        w = np.zeros_like(psi)
        for i, j in bonds:
            t = np.moveaxis(psi, (i, j), (0, 1))
            t = np.tensordot(h4, t, axes=([2, 3], [0, 1]))
            w += np.moveaxis(t, (0, 1), (i, j))
        return w.reshape(-1)

    cur = np.zeros(2**L, complex)
    cur[int("".join(str(i % 2) for i in range(L)), 2)] = 1.0
    bits = (np.arange(2**L)[:, None] >> np.arange(L - 1, -1, -1)) & 1
    stag = ((1 - 2 * bits) * ((-1) ** np.arange(L))).sum(1) / L
    dt, every = T / n, n // (n_report - 1)
    out = [1.0]
    for s in range(n):
        k1 = -1j * Hv(cur)
        k2 = -1j * Hv(cur + 0.5 * dt * k1)
        k3 = -1j * Hv(cur + 0.5 * dt * k2)
        k4 = -1j * Hv(cur + dt * k3)
        cur = cur + (dt / 6) * (k1 + 2 * k2 + 2 * k3 + k4)
        if (s + 1) % every == 0:
            p = np.abs(cur) ** 2
            out.append(float((p * stag).sum() / p.sum()))
    return np.array(out)


def neel_cell_state(D, eps=1e-2, seed=0):
    """|up down> cell product tensor padded to bond D with eps noise (numpy,
    seeded as the JAX example's)."""
    A0 = np.zeros((4, D, D), complex)
    A0[1, 0, 0] = 1.0  # cell basis (s1 s2): index 1 = |0>|1> = |up down>
    rng = np.random.default_rng(seed)
    return A0 + eps * (rng.standard_normal(A0.shape) + 1j * rng.standard_normal(A0.shape))


def main(device=None):
    dev = resolve_device(device)
    T, n_steps, D = 0.8, 320, 16
    h2 = np.asarray(heisenberg().to_matrix()).real
    print("ED reference (L=14 ring, RK4)...")
    ms_ed = ed_staggered(h2, T=T)

    print(f"blocked TDVP at D={D}...")
    traj = Trajectory(torch.as_tensor(neel_cell_state(D), device=dev),
                      torch.as_tensor(block_two_site(h2), dtype=torch.complex128, device=dev))
    traj.rk4int(T, n_steps)
    Z, I2 = np.diag([1.0, -1.0]), np.eye(2)
    op = torch.as_tensor((np.kron(Z, I2) - np.kron(I2, Z)) / 2, dtype=torch.complex128, device=dev)
    sel = np.linspace(0, n_steps, len(ms_ed)).astype(int)
    print(f"{'t':>6} {'m_s TDVP':>10} {'m_s ED':>10} {'diff':>9} {'S_half':>8}")
    diffs = []
    for k, i in enumerate(sel):
        st = iMPS([traj.ALs[i]])
        m, S = float(st.E(op).real), float(st.entanglement_entropy())
        diffs.append(abs(m - ms_ed[k]))
        print(f"{T * i / n_steps:>6.2f} {m:>10.5f} {ms_ed[k]:>10.5f} {m - ms_ed[k]:>9.1e} {S:>8.4f}")
    return {"max_diff": float(max(diffs))}


if __name__ == "__main__":
    main(cli_device())
