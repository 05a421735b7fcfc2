"""Exact-physics oracles in host numpy float64 (copies of
``qmps_tpu.ham.exact``'s quadratures):

- ``tfim_gs_energy(g)``: the TFIM ground-state energy per site in torch,
  in the caller's type and on its device; ``tfim_gs_energy_f64(g)``, its
  host float64 twin;
- ``loschmidt_rate(t, g0, g1)``: the exact rate function of a TFIM quench
  (qmps/exact_loschmidt.py:7-21);
- ``xy_gs_energy()``: the XY chain's free-fermion energy -4/pi;
- ``xxz_gs_energy(delta)`` and ``xxz_staggered_magnetization(delta)``:
  the Yang-Yang energy and Baxter's order parameter of the gapped Neel
  phase delta > 1.
"""
from __future__ import annotations

import math
from functools import lru_cache

import numpy as np
import torch


@lru_cache(maxsize=None)
def _gl_nodes(n: int = 256):
    x, w = np.polynomial.legendre.leggauss(n)
    # map [-1, 1] -> [0, pi]
    k = (x + 1) * (np.pi / 2)
    w = w * (np.pi / 2)
    return k, w


def tfim_gs_energy(g) -> torch.Tensor:
    """E0 per site of H = -ZZ + g X, the quadrature of ``tfim_gs_energy_f64``
    in torch: in g's type and on its device for a floating tensor, else in
    float64 on the CPU (the JAX package's oracle computes in JAX's default
    type)."""
    if not (isinstance(g, torch.Tensor) and g.is_floating_point()):
        g = torch.as_tensor(g, dtype=torch.float64)
    k, w = (torch.as_tensor(x, dtype=g.dtype, device=g.device) for x in _gl_nodes())
    eps = torch.sqrt(1.0 + g[..., None] ** 2 - 2.0 * g[..., None] * torch.cos(k))
    return -(eps * w).sum(-1) / math.pi


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


def xy_gs_energy() -> float:
    """E0 per site of the XY chain H = sum (XX + YY): free fermions at half
    filling, E = -(1/pi) Int_{-pi/2}^{pi/2} 2|2 cos k| dk / 2 = -4/pi.
    The oracle for the reference's bond-dimension scaling experiment
    (scripts/bond_dimension.py:18), which published no anchor."""
    import math

    return -4.0 / math.pi


def xxz_gs_energy(delta: float) -> float:
    """Exact ground energy per site of H = sum (XX + YY + delta ZZ) in
    the gapped Neel phase delta > 1 (Yang-Yang 1966; Orbach-Walker sum):
    with lam = arccosh(delta),

        e = delta - 4 sinh(lam) [ 1/2 + 2 sum_{n>=1} 1/(1 + e^{2 n lam}) ]

    (the Pauli-convention x4 of the S.S form delta/4 - sinh(lam)(...)).
    The lam -> 0 limit recovers the Heisenberg value 1 - 4 ln 2.
    Validated here against cell-blocked VUMPS at D=16 to 1e-6
    (tests/test_tdvp_classical.py)."""
    import numpy as np

    if delta <= 1.0:
        raise ValueError("xxz_gs_energy covers the gapped phase delta > 1")
    lam = float(np.arccosh(delta))
    # the summand decays like e^{-2 n lam}: ~40/lam terms reach 1e-16
    # (a FIXED count silently truncates the lam -> 0 tail and the
    # Heisenberg limit comes out wrong by O(1))
    n_max = int(min(max(200.0, 40.0 / lam), 2e7))
    n = np.arange(1, n_max + 1)
    s = float(np.sum(1.0 / (1.0 + np.exp(np.minimum(2 * n * lam, 700.0)))))
    return delta - 4.0 * np.sinh(lam) * (0.5 + 2.0 * s)


def xxz_staggered_magnetization(delta: float) -> float:
    """Baxter's spontaneous staggered magnetization of the XXZ chain
    (delta > 1), in sigma^z units:

        m_s = prod_{n>=1} [ (1 - q^{2n}) / (1 + q^{2n}) ]^2,  q = e^{-lam}.

    The order parameter of the Neel phase: |<Z_even>| = |<Z_odd>| = m_s
    with opposite signs on the two sublattices (measured from the
    cell-blocked VUMPS state to 5e-4 at D=8)."""
    import numpy as np

    if delta <= 1.0:
        raise ValueError(
            "xxz_staggered_magnetization covers the gapped phase delta > 1"
        )
    lam = float(np.arccosh(delta))
    q = float(np.exp(-lam))
    n_max = int(min(max(400.0, 20.0 / lam), 2e7))
    q2n = q ** (2 * np.arange(1, n_max + 1))
    return float(np.prod(((1.0 - q2n) / (1.0 + q2n)) ** 2))
