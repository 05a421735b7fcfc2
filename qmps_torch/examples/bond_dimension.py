"""Bond-dimension ladder of the XY chain: each D warm-started from the
previous D's optimum through the su(N) embedding (scripts/bond_dimension.py;
examples/bond_dimension.py of the JAX package).

Run:  python -m qmps_torch.examples.bond_dimension [--cpu]
"""
import numpy as np
import torch

from qmps_torch.algorithms import find_ground_state
from qmps_torch.config import resolve_device
from qmps_torch.core import lie
from qmps_torch.examples import cli_device
from qmps_torch.ham import xy


def main(device=None):
    dev = resolve_device(device)
    H = xy()
    guess = None
    rows = {}
    print(f"{'D':>3} {'E':>12}")
    for D in (2, 4, 8):
        candidates = []
        for seed in (0, 1, 2):
            ig = guess if (guess is not None and seed == 0) else None
            candidates.append(find_ground_state(H, D=D, ansatz="suN", method="lbfgs", steps=300, initial_guess=ig,
                                                generator=torch.Generator().manual_seed(seed), device=dev))
        res = min(candidates, key=lambda r: r.energy)
        rows[D] = res.energy
        print(f"{D:3d} {res.energy:12.8f}")
        guess = torch.as_tensor(lie.embed_su_params(res.params.cpu().numpy(), eps=4e-2)).to(dev, res.params.dtype)
    # exact XY ground energy per site with these conventions: -4/pi
    print(f"     exact: {-4 / np.pi:.8f}")
    return rows


if __name__ == "__main__":
    main(cli_device())
