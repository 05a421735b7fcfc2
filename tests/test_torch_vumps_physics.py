"""The physics of qmps_torch's VUMPS on the CPU at complex128, each
against an exact oracle: the XY and Heisenberg chains, the GMRES
environments' convergence, and (``slow``, as in the JAX package)
criticality, the central charges, the Bethe value at D = 16, D = 32, the
blocked XXZ chain against Yang-Yang and Baxter, and the variance
certificates of tests/test_variance.py:150-199.  The VUMPS parity tests
against qmps_tpu are in test_torch_vumps.py.
"""
import numpy as np
import pytest
import torch

import _torch_parity  # noqa: F401  (one torch thread a worker)
from qmps_torch.ham.classical_baselines import heisenberg_exact_energy
from qmps_torch.ham.exact import tfim_gs_energy_f64, xy_gs_energy
from qmps_torch.ham.hamiltonian import heisenberg, sublattice_rotate, tfim, xy
from qmps_torch.mps import tdvp as ttd
from qmps_torch.mps.imps import iMPS

E1 = float(tfim_gs_energy_f64(1.0))


def _random_A(seed, D, d=2):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((d, D, D)) + 1j * rng.standard_normal((d, D, D))


def test_vumps_xy_and_heisenberg_oracles():
    """The sublattice-rotated XY chain at D = 8 (300 iterations, k = 32)
    within 1e-3 of -4/pi with gradient < 1e-8; Heisenberg within 3e-3 of
    the Bethe value."""
    _, _, e, info = ttd.vumps_ground_state(sublattice_rotate(xy()), 8, iters=300, k=32, device="cpu")
    assert abs(e - xy_gs_energy()) < 1e-3
    assert float(info["grad_norms"][-1]) < 1e-8
    _, _, e, _ = ttd.vumps_ground_state(sublattice_rotate(heisenberg(1.0)), 8, iters=300, k=32, device="cpu")
    assert abs(e - heisenberg_exact_energy()) < 3e-3


def test_vumps_gmres_converges_like_dense():
    """D = 8, 150 iterations with the GMRES environments: gradient < 1e-10,
    error in [0, 1e-5)."""
    _, _, e, info = ttd.vumps_ground_state(tfim(1.0).to_matrix(), 8, iters=150, env_solver="gmres",
                                           device="cpu")
    assert float(info["grad_norms"][-1]) < 1e-10
    assert 0 <= e - E1 < 1e-5


@pytest.mark.slow
def test_bare_heisenberg_converges_via_cell2():
    """The bare Heisenberg chain, blocked (D = 8, 250 iterations): within
    2e-3 of the Bethe value, gradient < 1e-4."""
    _, _, e, info = ttd.vumps_ground_state_cell2(heisenberg(1.0), 8, iters=250, device="cpu")
    assert abs(e - heisenberg_exact_energy()) < 2e-3
    assert float(info["grad_norms"][-1]) < 1e-4


@pytest.mark.slow
def test_cell2_vumps_hits_yang_yang_and_baxter():
    """Blocked XXZ at delta = 2: D = 8 within 5e-5 of Yang-Yang, D = 16
    within 5e-6, both variational; the staggered magnetization within
    1e-3 of Baxter's, opposite on the sublattices, at least Baxter's."""
    from qmps_torch.ham.exact import xxz_gs_energy, xxz_staggered_magnetization
    from qmps_torch.ham.hamiltonian import xxz

    h = xxz(2.0).to_matrix()
    e_exact = xxz_gs_energy(2.0)
    AL8, _, e8, info8 = ttd.vumps_ground_state_cell2(h, 8, iters=200, device="cpu")
    assert float(info8["grad_norms"][-1]) < 1e-8
    assert e_exact - 1e-9 <= e8 < e_exact + 5e-5
    _, _, e16, _ = ttd.vumps_ground_state_cell2(h, 16, iters=200, device="cpu")
    assert e_exact - 1e-9 <= e16 < e_exact + 5e-6
    Z, I2 = np.diag([1.0, -1.0]), np.eye(2)
    st = iMPS([AL8])
    m_even = float(st.E(torch.from_numpy(np.kron(Z, I2) + 0j)).real)
    m_odd = float(st.E(torch.from_numpy(np.kron(I2, Z) + 0j)).real)
    ms = xxz_staggered_magnetization(2.0)
    assert abs(m_even + m_odd) < 1e-6
    assert abs(abs(m_even) - ms) < 1e-3 and abs(m_even) >= ms - 1e-6


def _grow(AL, D_new, seed, eps=1e-3):
    """examples/central_charge.py's grow: AL in the corner of a (d, D_new,
    D_new) tensor plus eps complex noise."""
    d, D, _ = AL.shape
    out = torch.zeros((d, D_new, D_new), dtype=AL.dtype)
    out[:, :D, :D] = AL
    return out + eps * torch.from_numpy(_random_A(seed, D_new, d)).to(AL.dtype)


def _scaling_rows(h, e_exact, Ds, iters):
    rows, prev = [], None
    for D in Ds:
        A0 = None if prev is None else _grow(prev, D, 7)
        AL, _, e, _ = ttd.vumps_ground_state(h, D, iters=iters, k=32, A0=A0, device="cpu")
        st = iMPS([AL])
        rows.append((e - e_exact, float(st.entanglement_entropy()), float(st.correlation_length())))
        prev = AL
    return rows


def _central_charge(rows):
    return 6.0 * np.polyfit(np.log([r[2] for r in rows]), [r[1] for r in rows], 1)[0]


@pytest.mark.slow
def test_central_charge_scaling():
    """S = (c/6) log xi over D = 4, 8, 12 (grown starts, 300 iterations)
    gives the Ising c = 1/2 within (0.40, 0.56); every error in (-1e-6,
    1e-4)."""
    rows = _scaling_rows(tfim(1.0).to_matrix(), E1, (4, 8, 12), 300)
    assert all(-1e-6 < r[0] < 1e-4 for r in rows)
    assert 0.40 < _central_charge(rows) < 0.56


@pytest.mark.slow
def test_central_charge_xy_is_one():
    """The rotated XY chain over D = 8, 12, 16 (400 iterations) is a c = 1
    CFT: c within (0.82, 1.1), every error in (-1e-6, 5e-3)."""
    rows = _scaling_rows(sublattice_rotate(xy()), xy_gs_energy(), (8, 12, 16), 400)
    assert all(-1e-6 < r[0] < 5e-3 for r in rows)
    assert 0.82 < _central_charge(rows) < 1.1


@pytest.mark.slow
def test_vumps_heisenberg_bethe_D16():
    """D = 16 grown from D = 8 (300 iterations each, k = 32): within 3e-4 of
    the Bethe value, gradient < 1e-8."""
    hh = sublattice_rotate(heisenberg(1.0))
    AL8, _, _, _ = ttd.vumps_ground_state(hh, 8, iters=300, k=32, device="cpu")
    _, _, e, info = ttd.vumps_ground_state(hh, 16, iters=300, k=32, A0=_grow(AL8, 16, 3), device="cpu")
    assert abs(e - heisenberg_exact_energy()) < 3e-4
    assert float(info["grad_norms"][-1]) < 1e-8


@pytest.mark.slow
def test_vumps_D32_critical():
    """D = 32 at g = 1 by the auto (GMRES) path, grown 8 -> 16 -> 32:
    error in [0, 5e-5), the reported energy the returned state's (1e-11)."""
    h = tfim(1.0).to_matrix()
    AL8, _, _, _ = ttd.vumps_ground_state(h, 8, iters=150, device="cpu")
    AL16, _, _, _ = ttd.vumps_ground_state(h, 16, iters=150, A0=_grow(AL8, 16, 3), device="cpu")
    AL32, _, e32, _ = ttd.vumps_ground_state(h, 32, iters=80, A0=_grow(AL16, 32, 4), device="cpu")
    assert 0 <= e32 - E1 < 5e-5
    assert abs(e32 - float(iMPS([AL32]).energy(torch.from_numpy(h)))) < 1e-11


@pytest.mark.slow
def test_variance_extrapolation_beats_largest_D():
    """E(sigma^2) -> 0 extrapolated over D = 2, 3, 4 (300 iterations) lands
    closer to exact than the D = 4 point, by 2x (tests/test_variance.py:
    150-175)."""
    h = torch.from_numpy(tfim(1.0).to_matrix())
    pts = []
    for D in (2, 3, 4):
        AL, C, e, _ = ttd.vumps_ground_state(h, D, iters=300, generator=torch.Generator().manual_seed(D))
        r = C @ C.mH
        pts.append((e, float(ttd.energy_variance_density(AL, r / torch.trace(r), h))))
    e_arr, v = np.array([p[0] for p in pts]), np.array([p[1] for p in pts])
    w = 1.0 / np.maximum(v, 1e-14)
    (e0, _), *_ = np.linalg.lstsq(np.stack([np.ones_like(v), v], axis=1) * w[:, None], e_arr * w, rcond=None)
    assert abs(e0 - E1) < 0.5 * abs(e_arr[-1] - E1)


@pytest.mark.slow
def test_vumps_state_certifies_its_energy_error():
    """At g = 1.2 (gap 0.4), D = 8, 400 iterations: the variance bounds the
    energy error, |E - E0| <= sigma^2 / gap, and is < 1e-6
    (tests/test_variance.py:177-199)."""
    g = 1.2
    h = torch.from_numpy(tfim(g).to_matrix())
    AL, C, e, _ = ttd.vumps_ground_state(h, 8, iters=400)
    r = C @ C.mH
    var = float(ttd.energy_variance_density(AL, r / torch.trace(r), h))
    err = e - float(tfim_gs_energy_f64(g))
    assert var >= -1e-10
    assert err <= var / (2 * abs(1 - g)) + 1e-9
    assert var < 1e-6
