"""The hand-written CUDA kernels against their plain PyTorch versions, on
the card.  Every test here is marked ``cuda`` and skips without a card;
run them on one with

    python -m pytest -p no:cacheprovider --noconftest -m cuda tests/test_torch_cuda.py

(``--noconftest`` skips the suite's JAX set-up in conftest.py, which
this file does not use).
"""
import numpy as np
import pytest
import torch

from _torch_parity import left_canonical, phase_aligned, require_cuda, tfim_h, to_np, transfer_matrices
from qmps_torch.ham.classical_baselines import host_energy_d2
from qmps_torch.kernels import _lib
from qmps_torch.kernels import energy_fused as tef
from qmps_torch.kernels.pallas_power import dominant_eig_batched
from qmps_torch.parallel.sweep import sweep_ground_states_fused


@pytest.mark.cuda
@pytest.mark.parametrize("method,iters", [("squaring", 40), ("power", 96)])
def test_k1_matches_plain(method, iters):
    """K1 (complex64) against the plain version at complex128 on the same
    inputs: lam to 1e-5, v to 1e-4 up to its phase; one launch."""
    dev = require_cuda()
    E = torch.from_numpy(transfer_matrices(1000, seed=2).astype(np.complex64)).to(dev)
    _lib.reset_launches()
    lam, v = dominant_eig_batched(E, iters=iters, method=method)
    torch.cuda.synchronize()
    assert _lib.launches["dominant_eig"] == 1
    lam_p, v_p = dominant_eig_batched(E.cpu().to(torch.complex128), iters=iters, method=method)
    np.testing.assert_allclose(to_np(lam), to_np(lam_p), atol=1e-5)
    np.testing.assert_allclose(phase_aligned(to_np(v), to_np(v_p)), to_np(v_p), atol=1e-4)


@pytest.mark.cuda
def test_k2_k3_match_plain():
    """K2 and K3 (complex64) against the plain versions at complex128:
    e to 2e-5, lam to 1e-5, v (phase-fixed, so compared as is) to 1e-4,
    hbar to 3e-4, Abar to 3e-4 times max(1, the element's largest |Abar|)
    (f32's eigenvector error ~eps/gap reaches Abar, which itself grows as
    1/gap); one launch each."""
    dev = require_cuda()
    B = 1000
    A = torch.from_numpy(left_canonical(np.random.default_rng(3), B).astype(np.complex64))
    h = torch.from_numpy(tfim_h(np.linspace(0.1, 2.0, B)).astype(np.complex64))
    ct = torch.ones(B)
    _lib.reset_launches()
    e, lam, v = tef._fwd_cuda(A.to(dev), h.to(dev), 48)
    Abar, hbar = tef._bwd_cuda(A.to(dev), h.to(dev), lam, v, ct.to(dev))
    torch.cuda.synchronize()
    assert _lib.launches["energy_fwd"] == 1 and _lib.launches["energy_bwd"] == 1
    A64, h64 = A.to(torch.complex128), h.to(torch.complex128)
    e_p, lam_p, v_p = tef._fwd_plain(A64, h64, 48)
    Abar_p, hbar_p = tef._bwd_plain(A64, h64, lam_p, v_p, ct.double())
    np.testing.assert_allclose(to_np(e), to_np(e_p), atol=2e-5)
    np.testing.assert_allclose(to_np(lam), to_np(lam_p), atol=1e-5)
    np.testing.assert_allclose(to_np(v), to_np(v_p), atol=1e-4)
    np.testing.assert_allclose(to_np(hbar), to_np(hbar_p), atol=3e-4)
    err = np.abs(to_np(Abar) - to_np(Abar_p)).reshape(B, -1).max(1)
    scale = np.maximum(1.0, np.abs(to_np(Abar_p)).reshape(B, -1).max(1))
    assert np.all(err <= 3e-4 * scale), (err / scale).max()


@pytest.mark.cuda
def test_sweep_on_card():
    """A short sweep on the card runs through K2 and K3 on every step and
    returns finite, left-canonical tensors whose float64 energies sit at
    or above the exact ones."""
    dev = require_cuda()
    g = np.linspace(0.2, 1.8, 16)
    _lib.reset_launches()
    es, As = sweep_ground_states_fused(torch.tensor(g, device=dev), steps=60, restarts=2)
    torch.cuda.synchronize()
    assert _lib.launches == {"dominant_eig": 0, "energy_fwd": 61, "energy_bwd": 60}
    assert es.device.type == "cuda" and As.dtype == torch.complex64
    A = to_np(As).astype(np.complex128)
    assert np.all(np.isfinite(A))
    lc = np.einsum("bsik,bsij->bkj", A.conj(), A)
    np.testing.assert_allclose(lc, np.broadcast_to(np.eye(2), lc.shape), atol=1e-5)
    e64 = np.array([host_energy_d2(A[b], tfim_h(g[b])) for b in range(16)])
    assert np.all(np.isfinite(e64)) and np.all(np.abs(e64 - to_np(es)) < 1e-3)
