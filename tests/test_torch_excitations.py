"""The quasiparticle excitations of qmps_torch (mps/excitations) against
qmps_tpu's at complex128 on the CPU, and tests/test_excitations.py's
physics against the exact TFIM dispersion 2 sqrt(1 + g^2 - 2 g cos p).

null_space_VL's complete QR fixes its completion's column phases as the
solver does, so the port's H_X is a unitary similarity of JAX's: spectra,
dispersions and spectral weights are compared, never H_X's entries.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import to_np
from qmps_torch.ham.hamiltonian import block_two_site, heisenberg, tfim
from qmps_torch.mps import excitations as tx
from qmps_torch.mps import tdvp as ttd
from qmps_torch.mps.imps import iMPS
from qmps_torch.utils.convert import from_mixed_gauge
from qmps_tpu.mps import excitations as jx
from qmps_tpu.mps import tdvp as jtd

Zm = np.diag([1.0, -1.0]) + 0j


def _gs(g, D, iters, k=32):
    """(h, the port's mixed gauge of its VUMPS ground state)."""
    h = tfim(g).to_matrix()
    AL, _, _, _ = ttd.vumps_ground_state(h, D, iters=iters, k=k, device="cpu")
    return h, ttd.mixed_gauge(AL)


def _exact(g, ps):
    return 2.0 * np.sqrt(1.0 + g * g - 2.0 * g * np.cos(ps))


@pytest.fixture(scope="module")
def gs_d4():
    """A converged g = 1.5, D = 4 ground state, as numpy from JAX's mixed
    gauge and as the port's tensors of it."""
    _, (AL, _, _) = _gs(1.5, 4, 150)
    mj = tuple(np.asarray(x) for x in jtd.mixed_gauge(jnp.asarray(to_np(AL))))
    return mj, from_mixed_gauge(mj)


@pytest.fixture(scope="module")
def gs_d8():
    return _gs(1.5, 8, 200)


def test_null_space_is_orthonormal_complement(gs_d4):
    """V_L has (d-1) D orthonormal columns (1e-12) and sum_s AL_s^dag VL_s =
    0 (1e-12)."""
    _, (AL, _, _) = gs_d4
    VL = tx.null_space_VL(AL)
    d, D, m = VL.shape
    assert m == (d - 1) * D
    M = VL.reshape(d * D, m)
    np.testing.assert_allclose(to_np(M.mH @ M), np.eye(m), atol=1e-12)
    assert float(torch.einsum("sia,sib->ab", AL.conj(), VL).abs().max()) < 1e-12


def test_effective_matrix_is_hermitian(gs_d4):
    """The raw diagram sum (symmetrize=False) at p = 0.7 is hermitian on a
    converged ground state (1e-9): a check of the diagram bookkeeping."""
    _, (AL, AR, C) = gs_d4
    HX = to_np(tx.excitation_matrix(AL, AR, C, tfim(1.5).to_matrix(), 0.7, symmetrize=False))
    np.testing.assert_allclose(HX, HX.conj().T, atol=1e-9)


@pytest.mark.parametrize("p", [0.0, 0.7, 2.5])
@pytest.mark.parametrize("deflate", [True, False])
def test_excitation_spectrum_matches_jax(gs_d4, p, deflate):
    """On the same (AL, AR, C): H_X's eigenvalues equal JAX's (1e-10),
    deflated or not."""
    mj, (AL, AR, C) = gs_d4
    h = tfim(1.5).to_matrix()
    got = np.linalg.eigvalsh(to_np(tx.excitation_matrix(AL, AR, C, h, p, deflate=deflate)))
    want = np.linalg.eigvalsh(np.asarray(jx.excitation_matrix(*(jnp.asarray(x) for x in (*mj, h)), p,
                                                              deflate=deflate)))
    np.testing.assert_allclose(got, want, atol=1e-10)


def test_spectral_weights_and_overlaps_match_jax(gs_d4):
    """spectral_weights at p = 0.5 on the same state: the six lowest
    energies (1e-10) and their weights (1e-10); the overlaps' norm
    (unitary-invariant, 1e-10)."""
    mj, (AL, AR, C) = gs_d4
    h = tfim(1.5).to_matrix()
    om, w = tx.spectral_weights(AL, AR, C, h, torch.from_numpy(Zm), 0.5, n_levels=6)
    omj, wj = jx.spectral_weights(*(jnp.asarray(x) for x in (*mj, h)), jnp.asarray(Zm), 0.5, n_levels=6)
    np.testing.assert_allclose(om, np.asarray(omj), atol=1e-10)
    np.testing.assert_allclose(w, np.asarray(wj), atol=1e-10)
    o = to_np(tx.excitation_overlaps(AL, AR, C, torch.from_numpy(Zm), 0.5))
    oj = np.asarray(jx.excitation_overlaps(*(jnp.asarray(x) for x in mj), jnp.asarray(Zm), 0.5))
    assert abs(np.linalg.norm(o) - np.linalg.norm(oj)) < 1e-10


def test_dispersion_on_a_given_state_matches_jax(gs_d4):
    """dispersion(gs=...) at four momenta equals JAX's (1e-10)."""
    mj, gs = gs_d4
    h = tfim(1.5).to_matrix()
    ps = np.linspace(0.0, np.pi, 4)
    np.testing.assert_allclose(tx.dispersion(h, 4, ps, n_levels=2, gs=gs),
                               np.asarray(jx.dispersion(h, 4, ps, n_levels=2,
                                                        gs=tuple(jnp.asarray(x) for x in mj))), atol=1e-10)


def test_tfim_dispersion_matches_exact():
    """g = 1.5, D = 8 (VUMPS 200 iterations inside ``dispersion``): the
    quasiparticle energy at five momenta, the gap 2|g - 1| at p = 0
    included, within 1e-7 of exact."""
    ps = np.linspace(0.0, np.pi, 5)
    om = tx.dispersion(tfim(1.5).to_matrix(), D=8, ps=ps, n_levels=1, iters=200, device="cpu")
    np.testing.assert_allclose(om[:, 0], _exact(1.5, ps), atol=1e-7)


def test_spectral_weights_sum_rule(gs_d8):
    """At g = 1.5, D = 8 the one-particle weights |<Phi_p|Z_p|GS>|^2
    saturate the static structure factor to 97-100% (the rest is the
    three-particle continuum), the lowest mode carrying > 99.9% of them,
    at its exact energy (1e-6)."""
    h, gs = gs_d8
    st = iMPS([gs[0]])
    Zt = torch.from_numpy(Zm)
    Cr = to_np(st.correlator(Zt, Zt, max_dist=60))
    ez = float(st.E(Zt).real)
    for p in (0.5, 2.5):
        om, w = tx.spectral_weights(*gs, h, Zt, p, n_levels=6)
        sp = (1.0 - ez ** 2) + 2 * np.sum(np.cos(p * np.arange(1, 61)) * Cr)
        np.testing.assert_allclose(float(st.static_structure_factor(Zt, p)), sp, atol=1e-10)
        assert abs(om[0] - _exact(1.5, p)) < 1e-6
        assert w[0] / np.sum(w) > 0.999
        assert 0.97 < np.sum(w) / sp <= 1.0


def test_domain_wall_dispersion_ordered_phase():
    """Kinks at g = 0.5 (D = 8, 200 iterations): the two-ground-state
    ansatz gives the exact fermion dispersion shifted by pi (1e-6)."""
    ps = np.linspace(0.0, np.pi, 5)
    om = tx.domain_wall_dispersion(tfim(0.5).to_matrix(), D=8, ps=ps, n_levels=1, iters=200, device="cpu")
    np.testing.assert_allclose(om[:, 0], _exact(0.5, ps + np.pi), atol=1e-6)


@pytest.mark.slow
def test_dispersion_other_couplings():
    """g = 1.2 at D = 8 and g = 2.0 at D = 4: within 1e-6 of exact at four
    momenta."""
    for g, D in ((1.2, 8), (2.0, 4)):
        ps = np.linspace(0.0, np.pi, 4)
        om = tx.dispersion(tfim(g).to_matrix(), D=D, ps=ps, n_levels=1, iters=200, device="cpu")
        np.testing.assert_allclose(om[:, 0], _exact(g, ps), atol=1e-6)


@pytest.mark.slow
def test_heisenberg_spinon_dispersion_via_cell2():
    """The blocked Heisenberg chain at D = 8: the lowest branch at cell
    momenta pi/2, pi, 3 pi/2 lies above the des Cloizeaux-Pearson edge
    2 pi |sin(kappa/2)| and within 2% of it; kappa and 2 pi - kappa agree
    (1e-6)."""
    hb = block_two_site(heisenberg().to_matrix())
    ps = np.array([np.pi / 2, np.pi, 3 * np.pi / 2])
    es = tx.dispersion(hb, 8, ps, n_levels=1, iters=250, device="cpu").ravel()
    exact = 2.0 * np.pi * np.abs(np.sin(ps / 2.0))
    assert np.all(es >= exact - 1e-6)
    np.testing.assert_allclose(es, exact, rtol=2e-2)
    assert abs(es[0] - es[2]) < 1e-6
