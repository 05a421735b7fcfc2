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
from qmps_torch.algorithms.evolve import batched_quench_sweep
from qmps_torch.algorithms.ground_state import find_ground_state
from qmps_torch.ham.classical_baselines import host_energy_d2
from qmps_torch.ham.exact import loschmidt_rate
from qmps_torch.ham.hamiltonian import tfim
from qmps_torch.kernels import _lib
from qmps_torch.kernels import energy_fused as tef
from qmps_torch.kernels import tdvp_fused as tdf
from qmps_torch.kernels.brickwork_fast import manifold_overlap_batched
from qmps_torch.kernels.brickwork_pallas import manifold_overlap_pallas
from qmps_torch.kernels.pallas_power import dominant_eig_batched
from qmps_torch.parallel.sweep import sweep_ground_states_fused, tfim_matrix


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
    assert _lib.launches == {"dominant_eig": 0, "energy_fwd": 61, "energy_bwd": 60, "tdvp_fwd": 0, "tdvp_bwd": 0,
                             "brickwork_overlap": 0}
    assert es.device.type == "cuda" and As.dtype == torch.complex64
    A = to_np(As).astype(np.complex128)
    assert np.all(np.isfinite(A))
    lc = np.einsum("bsik,bsij->bkj", A.conj(), A)
    np.testing.assert_allclose(lc, np.broadcast_to(np.eye(2), lc.shape), atol=1e-5)
    e64 = np.array([host_energy_d2(A[b], tfim_h(g[b])) for b in range(16)])
    assert np.all(np.isfinite(e64)) and np.all(np.abs(e64 - to_np(es)) < 1e-3)


def _tdvp_inputs(B, seed, batched_w):
    """Left-canonical A, B the nearest isometry to A + 0.05 noise, and W a
    quench gate expm(-i h(g1) 0.04) per element or one shared."""
    rng = np.random.default_rng(seed)
    A = left_canonical(rng, B)
    x = A.transpose(0, 2, 1, 3).reshape(B, 4, 2)
    x = x + 0.05 * (rng.standard_normal(x.shape) + 1j * rng.standard_normal(x.shape))
    U, _, Vh = np.linalg.svd(x, full_matrices=False)
    Bt = (U @ Vh).reshape(B, 2, 2, 2).transpose(0, 2, 1, 3)
    g1 = torch.from_numpy(rng.uniform(0.1, 0.4, B if batched_w else 1))
    W = torch.linalg.matrix_exp(-1j * tfim_matrix(g1).to(torch.complex128) * 0.04)
    return (torch.from_numpy(np.ascontiguousarray(A)), torch.from_numpy(np.ascontiguousarray(Bt)),
            W if batched_w else W[0])


@pytest.mark.cuda
@pytest.mark.parametrize("batched_w", [False, True])
def test_k4_k5_match_plain(batched_w):
    """K4 (with the left solve) and K5 (complex64) against the plain
    versions at complex128 on the same inputs: lam to 2e-5, v and w up to
    phase to 1e-4, Abar, Bbar and the per-element Wbar to 2e-4 times
    max(1, the element's largest |bar|); one launch each."""
    dev = require_cuda()
    B = 1000
    A, Bt, W = _tdvp_inputs(B, 7, batched_w)
    A32, B32, W32 = (t.to(dev, torch.complex64) for t in (A, Bt, W))
    ct = torch.ones(B)
    _lib.reset_launches()
    lam, v, w = tdf._fwd_cuda(A32, B32, W32, 48, True)
    bars = tdf._bwd_cuda(A32, B32, W32, lam, v, w, ct.to(dev))
    torch.cuda.synchronize()
    assert _lib.launches["tdvp_fwd"] == 1 and _lib.launches["tdvp_bwd"] == 1
    A64, B64, W64 = (t.cpu().to(torch.complex128) for t in (A32, B32, W32))
    W64 = W64.expand(B, 4, 4)
    lam_p, v_p, w_p = tdf._fwd_plain(A64, B64, W64, 48, True)
    bars_p = tdf._bwd_plain(A64, B64, W64, lam_p, v_p, w_p, ct.double())
    np.testing.assert_allclose(to_np(lam), to_np(lam_p), atol=2e-5)
    np.testing.assert_allclose(phase_aligned(to_np(v), to_np(v_p)), to_np(v_p), atol=1e-4)
    np.testing.assert_allclose(phase_aligned(to_np(w), to_np(w_p)), to_np(w_p), atol=1e-4)
    for k, p in zip(bars, bars_p):
        err = np.abs(to_np(k) - to_np(p)).reshape(B, -1).max(1)
        scale = np.maximum(1.0, np.abs(to_np(p)).reshape(B, -1).max(1))
        assert np.all(err <= 2e-4 * scale), (err / scale).max()


@pytest.mark.cuda
def test_objective_without_gradient_skips_the_left_solve():
    """Under no_grad the fused objective launches K4 once and no K5, and
    agrees with the gradient-mode value."""
    dev = require_cuda()
    A, Bt, W = (t.to(dev, torch.complex64) for t in _tdvp_inputs(64, 8, True))
    _lib.reset_launches()
    with torch.no_grad():
        f0 = tdf.tdvp_objective_fused(A, Bt, W)
    Bg = Bt.clone().requires_grad_()
    f1 = tdf.tdvp_objective_fused(A, Bg, W)
    f1.sum().backward()
    torch.cuda.synchronize()
    assert _lib.launches["tdvp_fwd"] == 2 and _lib.launches["tdvp_bwd"] == 1
    assert torch.equal(f0, f1.detach()) and torch.isfinite(Bg.grad).all()


@pytest.mark.cuda
def test_quench_on_card():
    """A short quench family on the card (float32: 4 trajectories, 10
    steps of 80 adam steps to t = 0.2, from the CPU's float64 ground state
    of tfim(1.5)) goes through K4 and K5 on every inner step and tracks the
    exact Loschmidt rate within 0.02 (test_evolve.py:47's bound)."""
    dev = require_cuda()
    g1 = np.array([0.1, 0.2, 0.3, 0.4])
    gs = find_ground_state(tfim(1.5), D=2, ansatz="full15", method="lbfgs", steps=300)
    _lib.reset_launches()
    times, les = batched_quench_sweep(1.5, torch.from_numpy(g1).to(dev), t_max=0.2, n_steps=10,
                                      inner_steps=80, params0=gs.params, engine="pallas")
    torch.cuda.synchronize()
    assert _lib.launches["tdvp_fwd"] == 800 and _lib.launches["tdvp_bwd"] == 800
    assert les.device.type == "cuda" and les.dtype == torch.float32 and les.shape == (4, 10)
    rates = -np.log(to_np(les).astype(np.float64))
    t = np.arange(1, 11) * 0.02
    for j, g in enumerate(g1):
        assert np.max(np.abs(rates[j] - loschmidt_rate(t, 1.5, g))) < 0.02, g


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 1000])
def test_k6_matches_plain(B):
    """K6 (complex64) against the plain version at complex128 on the same
    inputs, at batches that are not a multiple of the 64-element block, a
    shared W and Ml = M^dag passed as a lazy conjugate view: every element
    to 1e-5 in the complex difference (bench.py:115's bound); one launch."""
    dev = require_cuda()
    rng = np.random.default_rng(11)

    def hu(*shape):
        Q, _ = np.linalg.qr(rng.standard_normal(shape) + 1j * rng.standard_normal(shape))
        return torch.from_numpy(Q.astype(np.complex64)).to(dev)

    U1, U2, U1p, U2p = (hu(B, 4, 4) for _ in range(4))
    M, W = hu(B, 2, 2), hu(16, 16)
    _lib.reset_launches()
    out = manifold_overlap_pallas(U1, U2, U1p, U2p, M, M.mH, W)
    torch.cuda.synchronize()
    assert _lib.launches["brickwork_overlap"] == 1 and out.shape == (B,) and out.dtype == torch.complex64
    ref = manifold_overlap_batched(*(t.cpu().to(torch.complex128) for t in (U1, U2, U1p, U2p, M)),
                                   M.cpu().to(torch.complex128).mH, W.cpu().to(torch.complex128))
    assert np.abs(to_np(out) - to_np(ref)).max() <= 1e-5
