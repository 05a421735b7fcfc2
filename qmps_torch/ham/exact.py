"""Exact-physics oracles in host numpy float64 (copies of
``qmps_tpu.ham.exact``'s quadratures):

- ``tfim_gs_energy_f64(g)``: the TFIM ground-state energy per site;
- ``loschmidt_rate(t, g0, g1)``: the exact rate function of a TFIM quench
  (qmps/exact_loschmidt.py:7-21).
"""
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


def _f(z, g0, g1) -> np.ndarray:
    """The boundary partition-function exponent f(z) of the TFIM quench, on
    a 4096-node grid: near dynamical phase transitions the integrand has an
    (integrable) log singularity."""
    k, w = _gl_nodes(4096)

    def theta(k, g):
        return np.arctan2(np.sin(k), g - np.cos(k)) / 2

    phi = theta(k, g0) - theta(k, g1)
    eps = -2 * np.sqrt((g1 - np.cos(k)) ** 2 + np.sin(k) ** 2)
    integrand = -1 / (2 * np.pi) * np.log(
        np.cos(phi) ** 2 + np.sin(phi) ** 2 * np.exp(-2 * np.asarray(z)[..., None] * eps)
    )
    return (integrand * w).sum(-1)


def loschmidt_rate(t, g0, g1) -> np.ndarray:
    """Exact rate function lambda(t) = f(it) + f(-it) of the Loschmidt echo
    after a g0 -> g1 quench, for a scalar or an array of times."""
    t = np.asarray(t, np.complex128)
    return np.real(_f(1j * t, g0, g1) + _f(-1j * t, g0, g1))
