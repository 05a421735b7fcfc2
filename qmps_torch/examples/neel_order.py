"""The XXZ chain's Neel phase by cell-blocked VUMPS at D = 8: energies
against Yang-Yang and the staggered magnetization against Baxter
(examples/neel_order.py of the JAX package).  Runs in complex128.

Run:  python -m qmps_torch.examples.neel_order [--cpu]
"""
import numpy as np
import torch

from qmps_torch.config import resolve_device
from qmps_torch.examples import cli_device
from qmps_torch.ham import xxz, xxz_gs_energy, xxz_staggered_magnetization
from qmps_torch.mps import iMPS, vumps_ground_state_cell2


def main(device=None):
    dev = resolve_device(device)
    D = 8
    Z, I2 = np.diag([1.0, -1.0]), np.eye(2)
    op = torch.as_tensor(np.kron(Z, I2), dtype=torch.complex128, device=dev)
    print(f"XXZ Neel phase, cell-blocked VUMPS at D={D}")
    print(f"{'delta':>6} {'e':>12} {'e_YangYang':>12} {'err':>9} {'m_s':>9} {'m_Baxter':>9} {'diff':>9}")
    out = {}
    for delta in (1.5, 2.0, 3.0, 4.0):
        h = torch.as_tensor(xxz(delta).to_matrix(), dtype=torch.complex128, device=dev)
        AL, C, e, info = vumps_ground_state_cell2(h, D, iters=200, device=dev)
        m = abs(float(iMPS([AL]).E(op).real))
        e_ex, m_ex = xxz_gs_energy(delta), xxz_staggered_magnetization(delta)
        out[delta] = (e - e_ex, m - m_ex)
        print(f"{delta:>6.2f} {e:>12.8f} {e_ex:>12.8f} {e - e_ex:>9.1e} {m:>9.6f} {m_ex:>9.6f} {m - m_ex:>9.1e}")
    return out


if __name__ == "__main__":
    main(cli_device())
