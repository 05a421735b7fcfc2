"""Environment by power method: convergence in the number of transfer
applications (the Power Method.ipynb experiment; examples/power_method.py
of the JAX package).

Run:  python -m qmps_torch.examples.power_method [--cpu]
"""
import torch

from qmps_torch.config import default_dtypes, resolve_device
from qmps_torch.core.linalg import random_unitary
from qmps_torch.embed import unitary_to_tensor
from qmps_torch.env.exact import power_method_env
from qmps_torch.examples import cli_device
from qmps_torch.mps import transfer as tr


def main(device=None):
    dev = resolve_device(device)
    cdtype, _ = default_dtypes(dev)
    U = random_unitary(torch.Generator().manual_seed(3), 4, dtype=cdtype, device=dev)
    A = unitary_to_tensor(U)
    _, r_exact = tr.right_fixed_point(A, A)
    r_exact = (r_exact + r_exact.mH) / 2
    r_exact = r_exact / r_exact.diagonal().sum()
    print(f"{'k':>4} {'|r_k - r*|':>12}")
    out = {}
    for k in (1, 2, 4, 8, 16, 32, 64):
        out[k] = float(torch.linalg.matrix_norm(power_method_env(U, k) - r_exact))
        print(f"{k:4d} {out[k]:12.3e}")
    return out


if __name__ == "__main__":
    main(cli_device())
