"""Exact-physics oracle: the TFIM ground-state energy per site, in host
numpy float64 (a copy of ``qmps_tpu.ham.exact.tfim_gs_energy_f64``)."""
from __future__ import annotations

from functools import lru_cache

import numpy as np


@lru_cache(maxsize=None)
def _gl_nodes(n: int = 256):
    x, w = np.polynomial.legendre.leggauss(n)
    # map [-1, 1] -> [0, pi]
    k = (x + 1) * (np.pi / 2)
    w = w * (np.pi / 2)
    return k, w


def tfim_gs_energy_f64(g) -> np.ndarray:
    """E0 per site of H = -ZZ + g X:  -(1/pi) Int_0^pi sqrt(1+g^2-2g cos k) dk,
    by 256-node Gauss-Legendre quadrature in float64."""
    k, w = _gl_nodes()
    g = np.asarray(g, np.float64)[..., None]
    eps = np.sqrt(1.0 + g ** 2 - 2.0 * g * np.cos(k))
    return -(eps * w).sum(-1) / np.pi
