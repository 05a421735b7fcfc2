"""The hand-written CUDA kernels against their plain PyTorch versions, on
the card.  Every test here is marked ``cuda`` and skips without a card;
run them on one with

    python -m pytest -p no:cacheprovider --noconftest -m cuda tests/test_torch_cuda.py

(``--noconftest`` skips the suite's JAX set-up in conftest.py, which
this file does not use).
"""
import shutil
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import pytest
import torch

from _torch_parity import (left_canonical, nearest_isometry, phase_aligned, require_cuda, tfim_h, to_np,
                           transfer_matrices)
from qmps_torch import kernel_ab
from qmps_torch.algorithms.evolve import batched_quench_sweep
from qmps_torch.algorithms.ground_state import find_ground_state
from qmps_torch.ham.classical_baselines import host_energy_d2
from qmps_torch.ham.exact import loschmidt_rate
from qmps_torch.ham.hamiltonian import tfim
from qmps_torch.kernels import _lib
from qmps_torch.kernels import energy_fused as tef
from qmps_torch.kernels import pallas_power as tpp
from qmps_torch.kernels import tdvp_fused as tdf
from qmps_torch.kernels.brickwork_fast import manifold_overlap_batched
from qmps_torch.kernels.brickwork_pallas import manifold_overlap_pallas
from qmps_torch.kernels.pallas_power import dominant_eig_batched
from qmps_torch.mps.transfer import transfer_dense
from qmps_torch.objectives.overlap import mixed_transfer_with_gate, tdvp_objective, tdvp_objective_pallas
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
                             "brickwork_overlap": 0, "matpow_small": 0, "matpow_large": 0}
    assert es.device.type == "cuda" and As.dtype == torch.complex64
    A = to_np(As).astype(np.complex128)
    assert np.all(np.isfinite(A))
    lc = np.einsum("bsik,bsij->bkj", A.conj(), A)
    np.testing.assert_allclose(lc, np.broadcast_to(np.eye(2), lc.shape), atol=1e-5)
    e64 = np.array([host_energy_d2(A[b], tfim_h(g[b])) for b in range(16)])
    assert np.all(np.isfinite(e64)) and np.all(np.abs(e64 - to_np(es)) < 1e-3)


@pytest.mark.cuda
def test_sharded_sweep_on_card():
    """The fused sweep sharded over a mesh of the card twice (two worker
    threads, a stream each) against the same sweep unsharded: energies
    within 1e-6 and K2/K3 launched once a step by each shard."""
    from qmps_torch.parallel.mesh import Mesh

    dev = require_cuda()
    g = torch.tensor(np.linspace(0.2, 1.8, 16), device=dev)
    es, _ = sweep_ground_states_fused(g, steps=60, restarts=2)
    _lib.reset_launches()
    es_s, As_s = sweep_ground_states_fused(g, steps=60, restarts=2, mesh=Mesh((dev, dev)))
    torch.cuda.synchronize()
    assert _lib.launches["energy_fwd"] == 2 * 61 and _lib.launches["energy_bwd"] == 2 * 60
    assert es_s.shape == (16,) and As_s.shape == (16, 2, 2, 2) and es_s.is_cuda
    assert (es_s - es).abs().max().item() < 1e-6


@pytest.mark.cuda
def test_sharded_sweeps_over_every_card():
    """make_mesh() over two cards or more (skipped below two): the fused
    sweep (8 points a card, 2 restarts, 60 steps) and the quench family (4
    trajectories a card, K4/K5, 3 outer steps of 10) sharded against the
    same calls unsharded: energies and rates within 1e-6, the outputs on
    the first card, and K2 and K4 launched on every shard."""
    from qmps_torch.parallel import make_mesh

    dev = require_cuda()
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices or more")
    mesh = make_mesh()
    n = len(mesh)
    g = torch.tensor(np.linspace(0.2, 1.8, 8 * n), device=dev)
    es, _ = sweep_ground_states_fused(g, steps=60, restarts=2)
    _lib.reset_launches()
    es_s, As_s = sweep_ground_states_fused(g, steps=60, restarts=2, mesh=mesh)
    torch.cuda.synchronize()
    assert _lib.launches["energy_fwd"] == n * 61 and _lib.launches["energy_bwd"] == n * 60
    assert es_s.device == As_s.device == mesh.devices[0]
    assert (es_s - es).abs().max().item() < 1e-6
    p0 = torch.tensor([0.31, -0.72, 1.05, 0.4, -0.2, 0.66, 0.13, -0.9, 0.5, 0.27, -0.35, 0.8, 0.05, -0.6, 0.22])
    g1s = torch.linspace(0.1, 0.4, 4 * n, device=dev)
    kw = dict(t_max=0.06, n_steps=3, inner_steps=10, params0=p0, engine="pallas")
    _, les = batched_quench_sweep(1.5, g1s, **kw)
    _lib.reset_launches()
    _, les_s = batched_quench_sweep(1.5, g1s, mesh=mesh, **kw)
    torch.cuda.synchronize()
    assert _lib.launches["tdvp_fwd"] == n * 30 and _lib.launches["tdvp_bwd"] == n * 30
    assert les_s.device == mesh.devices[0] and les_s.shape == (4 * n, 3)
    assert (les_s - les).abs().max().item() < 1e-6


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
def test_mps_time_evolve_on_card(tmp_path):
    """MPSTimeEvolve in float32 on the card against the same run on the
    CPU in float32 (4 steps of 8 adam steps from one params0): loschmidt
    to 1e-5; it launches no hand kernel (the dense objective); and a run
    killed after 2 steps and resumed equals the uninterrupted one."""
    from qmps_torch.algorithms.evolve import MPSTimeEvolve

    dev = require_cuda()
    p0 = torch.from_numpy(np.random.default_rng(0).standard_normal(15) * 0.1).float()
    stepper = MPSTimeEvolve(tfim(0.5), dt=0.05, inner_steps=8)
    _lib.reset_launches()
    rec = stepper.evolve(p0.to(dev), 4)
    torch.cuda.synchronize()
    assert not any(_lib.launches.values())
    assert rec.loschmidt.device.type == "cuda" and rec.loschmidt.dtype == torch.float32
    ref = stepper.evolve(p0, 4)
    np.testing.assert_allclose(to_np(rec.loschmidt), to_np(ref.loschmidt), atol=1e-5)
    ckpt = str(tmp_path / "traj.npz")
    stepper.evolve(p0.to(dev), 2, checkpoint_path=ckpt, checkpoint_every=1)
    resumed = MPSTimeEvolve(tfim(0.5), dt=0.05, inner_steps=8).evolve(p0.to(dev), 4, checkpoint_path=ckpt)
    for f in ("params", "loschmidt", "evs", "errors"):
        assert torch.equal(getattr(resumed, f), getattr(rec, f)), f


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 1000, 16384])
def test_k6_matches_plain(B):
    """K6 (complex64) against the plain version at complex128 on the same
    inputs, at batches that are not a multiple of the 32-element block and
    at config 5's 16,384, a shared W and Ml = M^dag passed as a lazy
    conjugate view: every element to 1e-5 in the complex difference
    (bench.py:115's bound); one launch."""
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


@pytest.mark.cuda
@pytest.mark.parametrize("N", [9, 16, 25, 64, 256])
def test_k7_k8_match_plain(N):
    """K7 (N <= 16) and K8 (complex64; at N = 256 over its 64 x 64 tiles)
    against the plain version at complex128 on the same inputs,
    random matrices scaled by 1/sqrt(N) at a batch that is a multiple of no
    block, one of them zero: lam to 2e-5, v up to its phase to 1e-4, the
    zero element finite (lam = 0, v = 0); one launch."""
    dev = require_cuda()
    B = 37 if N == 256 else 301
    rng = np.random.default_rng(N)
    E = (rng.standard_normal((B, N, N)) + 1j * rng.standard_normal((B, N, N))) / np.sqrt(N)
    E[5] = 0
    E = torch.from_numpy(E.astype(np.complex64)).to(dev)
    _lib.reset_launches()
    lam, v = dominant_eig_batched(E)
    torch.cuda.synchronize()
    name = "matpow_small" if N <= 16 else "matpow_large"
    assert _lib.launches[name] == 1 and sum(_lib.launches.values()) == 1
    E64 = E.to(torch.complex128)  # the plain version, on the card
    lam_p, v_p = tpp._extract_eigpair(E64, tpp._matrix_power_plain(E64, 48))
    lam, v, lam_p, v_p = (to_np(t) for t in (lam, v, lam_p, v_p))
    assert lam[5] == 0 and not v[5].any()
    np.testing.assert_allclose(lam, lam_p, atol=2e-5)
    keep = np.arange(B) != 5
    np.testing.assert_allclose(phase_aligned(v[keep], v_p[keep]), v_p[keep], atol=1e-4)


@pytest.mark.cuda
def test_tdvp_objective_d4_on_card():
    """The D = 4 objective and its Bs-gradient on the card (complex64, K7)
    against the dense objective at complex128 on the same inputs: values
    to 2e-5, gradients to 2e-4 times max(1, the element's largest |grad|);
    one K7 launch for the value and gradient, none in the backward."""
    dev = require_cuda()
    B = 200
    rng = np.random.default_rng(12)
    A = left_canonical(rng, B, 4)
    Bt = nearest_isometry(A + 0.03 * (rng.standard_normal(A.shape) + 1j * rng.standard_normal(A.shape)))
    g1 = torch.from_numpy(rng.uniform(0.1, 0.4, B))
    W = torch.linalg.matrix_exp(-1j * tfim_matrix(g1).to(torch.complex128) * 0.04)
    A32, B32, W32 = (torch.as_tensor(t).to(dev, torch.complex64) for t in (A, Bt, W))
    Bg = B32.clone().requires_grad_()
    _lib.reset_launches()
    val = tdvp_objective_pallas(A32, Bg, W32, 48)
    assert _lib.launches["matpow_small"] == 1
    val.sum().backward()
    torch.cuda.synchronize()
    assert _lib.launches["matpow_small"] == 1 and sum(_lib.launches.values()) == 1
    B64 = B32.to(torch.complex128).requires_grad_()
    ref = tdvp_objective(A32.to(torch.complex128), B64, W32.to(torch.complex128))
    ref.sum().backward()
    np.testing.assert_allclose(to_np(val), to_np(ref), atol=2e-5)
    err = np.abs(to_np(Bg.grad) - to_np(B64.grad)).reshape(B, -1).max(1)
    scale = np.maximum(1.0, np.abs(to_np(B64.grad)).reshape(B, -1).max(1))
    assert np.all(err <= 2e-4 * scale), (err / scale).max()


@pytest.mark.cuda
@pytest.mark.parametrize("N", [25, 36, 49, 64])
def test_k8_tensor_cores_match_plain(N):
    """K8 on the tensor cores (3xTF32; padded to 32, 48, 64, 64: every
    layout) against the complex128 plain version on D = 5..8 TDVP transfer
    matrices and one zero matrix: lam to 2e-5, v and the left vector read
    off the same power up to phase to 1e-4; one launch."""
    dev = require_cuda()
    D, B = int(round(N ** 0.5)), 300
    rng = np.random.default_rng(40 + N)
    A = left_canonical(rng, B, D)
    Bt = nearest_isometry(A + 0.03 * (rng.standard_normal(A.shape) + 1j * rng.standard_normal(A.shape)))
    W = torch.linalg.matrix_exp(-1j * tfim_matrix(torch.from_numpy(rng.uniform(0.1, 0.4, B))) * 0.04)
    E = transfer_dense(*mixed_transfer_with_gate(*(torch.as_tensor(t) for t in (A, Bt, W))))
    E[7] = 0
    E = E.to(dev, torch.complex64).contiguous()
    _lib.reset_launches()
    M = tpp._matrix_power_cuda(E, 48)
    torch.cuda.synchronize()
    assert _lib.launches["matpow_large"] == 1
    lam, v = tpp._extract_eigpair(E.to(torch.complex128), M.to(torch.complex128))
    w = tpp._left_vector(M.to(torch.complex128))
    E64 = E.cpu().to(torch.complex128)
    M_p = tpp._matrix_power_plain(E64, 48)
    lam_p, v_p = tpp._extract_eigpair(E64, M_p)
    w_p = tpp._left_vector(M_p)
    lam, v, w, lam_p, v_p, w_p = (to_np(t) for t in (lam, v, w, lam_p, v_p, w_p))
    assert lam[7] == 0 and not v[7].any() and not w[7].any()
    np.testing.assert_allclose(lam, lam_p, atol=2e-5)
    keep = np.arange(B) != 7
    np.testing.assert_allclose(phase_aligned(v[keep], v_p[keep]), v_p[keep], atol=1e-4)
    np.testing.assert_allclose(phase_aligned(w[keep], w_p[keep]), w_p[keep], atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("B", [64, 65536])
def test_k4_layouts_match_plain(B):
    """K4 at the quench's batch (64, a quad of lanes an element) and at
    65,536 (one thread an element) against the plain version at complex128,
    with the left vector: the tolerances of chip_smoke.tdvp_check (-|lam|
    and lam 2e-5, v and u up to phase 1e-4); one launch."""
    dev = require_cuda()
    A, Bt, W = _tdvp_inputs(B, 9, True)
    A32, B32, W32 = (t.to(dev, torch.complex64) for t in (A, Bt, W))
    _lib.reset_launches()
    lam, v, u = tdf._fwd_cuda(A32, B32, W32, 48, True)
    torch.cuda.synchronize()
    assert _lib.launches["tdvp_fwd"] == 1
    lam_p, v_p, u_p = tdf._fwd_plain(*(t.to(torch.complex128) for t in (A32, B32, W32)), 48, True)
    lam, v, u, lam_p, v_p, u_p = (to_np(t) for t in (lam, v, u, lam_p, v_p, u_p))
    np.testing.assert_allclose(np.abs(lam), np.abs(lam_p), atol=2e-5)
    np.testing.assert_allclose(lam, lam_p, atol=2e-5)
    np.testing.assert_allclose(phase_aligned(v, v_p), v_p, atol=1e-4)
    np.testing.assert_allclose(phase_aligned(u, u_p), u_p, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("B", [64, 65536])
def test_k5_layouts_match_plain(B):
    """K5 (16 lanes an element, its one layout) at the quench's batch (64)
    and at 65,536 against the plain adjoint at complex128 on K4's
    outputs, with a cotangent that varies by element: Abar, Bbar and Wbar
    to 2e-4 times max(1, the element's largest |bar|) (chip_smoke.
    tdvp_check's gate); one launch."""
    dev = require_cuda()
    A, Bt, W = _tdvp_inputs(B, 10, True)
    A32, B32, W32 = (t.to(dev, torch.complex64) for t in (A, Bt, W))
    lam, v, u = tdf._fwd_cuda(A32, B32, W32, 48, True)
    ct = torch.linspace(0.5, 1.5, B, device=dev)
    _lib.reset_launches()
    bars = tdf._bwd_cuda(A32, B32, W32, lam, v, u, ct)
    torch.cuda.synchronize()
    assert _lib.launches["tdvp_bwd"] == 1 and sum(_lib.launches.values()) == 1
    c128 = torch.complex128
    bars_p = tdf._bwd_plain(*(t.to(c128) for t in (A32, B32, W32, lam, v, u)), ct.double())
    for k, p in zip(bars, bars_p):
        err = (k.to(c128) - p).abs().reshape(B, -1).max(1).values
        scale = p.abs().reshape(B, -1).max(1).values.clamp(min=1.0)
        assert bool((err <= 2e-4 * scale).all()), (err / scale).max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("B", [4096, 65536])
def test_k2_layouts_match_plain(B):
    """K2 at the sweep's batch (4,096) and at 65,536, each layout the
    launcher can pick there, against the plain forward at complex128:
    e 2e-5, lam 1e-5, v (phase-fixed) 1e-4, chip_smoke.py phase 4's gates;
    one launch."""
    dev = require_cuda()
    A = torch.from_numpy(left_canonical(np.random.default_rng(13), B).astype(np.complex64)).to(dev)
    h = torch.from_numpy(tfim_h(np.linspace(0.1, 2.0, B)).astype(np.complex64)).to(dev)
    _lib.reset_launches()
    e, lam, v = tef._fwd_cuda(A, h, 48)
    torch.cuda.synchronize()
    assert _lib.launches["energy_fwd"] == 1 and sum(_lib.launches.values()) == 1
    e_p, lam_p, v_p = tef._fwd_plain(A.to(torch.complex128), h.to(torch.complex128), 48)
    assert (e.double() - e_p).abs().max().item() < 2e-5
    assert (lam.to(torch.complex128) - lam_p).abs().max().item() < 1e-5
    assert (v.to(torch.complex128) - v_p).abs().max().item() < 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("B", [4096, 65536])
def test_k3_layouts_match_plain(B):
    """K3 at the sweep's batch (4,096) and at 65,536, each layout the
    launcher can pick there, against the plain adjoint at complex128 on
    K2's outputs, with a cotangent that varies by element: hbar 3e-4, Abar
    3e-4 times max(1, the element's largest |Abar|), chip_smoke.py phase
    4's gates; one launch."""
    dev = require_cuda()
    A = torch.from_numpy(left_canonical(np.random.default_rng(14), B).astype(np.complex64)).to(dev)
    h = torch.from_numpy(tfim_h(np.linspace(0.1, 2.0, B)).astype(np.complex64)).to(dev)
    _, lam, v = tef._fwd_cuda(A, h, 48)
    ct = torch.linspace(0.5, 1.5, B, device=dev)
    _lib.reset_launches()
    Abar, hbar = tef._bwd_cuda(A, h, lam, v, ct)
    torch.cuda.synchronize()
    assert _lib.launches["energy_bwd"] == 1 and sum(_lib.launches.values()) == 1
    c128 = torch.complex128
    Abar_p, hbar_p = tef._bwd_plain(A.to(c128), h.to(c128), lam.to(c128), v.to(c128), ct.double())
    assert (hbar.to(c128) - hbar_p).abs().max().item() < 3e-4
    err = (Abar.to(c128) - Abar_p).abs().reshape(B, -1).max(1).values
    scale = Abar_p.abs().reshape(B, -1).max(1).values.clamp(min=1.0)
    assert bool((err <= 3e-4 * scale).all()), (err / scale).max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("N", [9, 12, 13, 16])
def test_k7_tensor_cores_match_plain(N):
    """K7 at N = 9, 12, 13 and 16, on whichever unit its launcher picks
    there (the tensor cores in 3xTF32, padded to 16, from kMatpowTcMinN),
    against the complex128 plain version on random matrices scaled by
    1/sqrt(N), a batch that is a multiple of no block, one matrix zero:
    lam to 2e-5, v and the left vector read off the same power up to phase
    to 1e-4, the zero element zero; one launch."""
    dev = require_cuda()
    B = 301
    rng = np.random.default_rng(70 + N)
    E = (rng.standard_normal((B, N, N)) + 1j * rng.standard_normal((B, N, N))) / np.sqrt(N)
    E[3] = 0
    E = torch.from_numpy(E.astype(np.complex64)).to(dev)
    _lib.reset_launches()
    M = tpp._matrix_power_cuda(E, 48)
    torch.cuda.synchronize()
    assert _lib.launches["matpow_small"] == 1 and sum(_lib.launches.values()) == 1
    E64, M64 = E.to(torch.complex128), M.to(torch.complex128)
    M_p = tpp._matrix_power_plain(E64, 48)
    lam, v = tpp._extract_eigpair(E64, M64)
    lam_p, v_p = tpp._extract_eigpair(E64, M_p)
    w, w_p = tpp._left_vector(M64), tpp._left_vector(M_p)
    lam, v, w, lam_p, v_p, w_p = (to_np(t) for t in (lam, v, w, lam_p, v_p, w_p))
    assert not to_np(M)[3].any() and lam[3] == 0 and not v[3].any()
    np.testing.assert_allclose(lam, lam_p, atol=2e-5)
    keep = np.arange(B) != 3
    np.testing.assert_allclose(phase_aligned(v[keep], v_p[keep]), v_p[keep], atol=1e-4)
    np.testing.assert_allclose(phase_aligned(w[keep], w_p[keep]), w_p[keep], atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("N", [81, 256])
def test_k8_tiles_match_plain(N):
    """K8 above N = 64 (matpow_tc_tiles_kernel, the squarings over 64 x 64
    tiles of the whole batch in 3xTF32; N = 81 padded to 128) against the
    complex128 plain version on D = 9 and 16 TDVP transfer matrices and
    one zero matrix: lam to 2e-5, v and the left vector off the same power
    up to phase to 1e-4; one launch, and the same bits on a second call (no
    atomics in the norms)."""
    dev = require_cuda()
    D, B = int(round(N ** 0.5)), 64
    rng = np.random.default_rng(50 + N)
    A = left_canonical(rng, B, D)
    Bt = nearest_isometry(A + 0.03 * (rng.standard_normal(A.shape) + 1j * rng.standard_normal(A.shape)))
    W = torch.linalg.matrix_exp(-1j * tfim_matrix(torch.from_numpy(rng.uniform(0.1, 0.4, B))) * 0.04)
    E = transfer_dense(*mixed_transfer_with_gate(*(torch.as_tensor(t) for t in (A, Bt, W))))
    E[7] = 0
    E = E.to(dev, torch.complex64).contiguous()
    _lib.reset_launches()
    M = tpp._matrix_power_cuda(E, 48)
    torch.cuda.synchronize()
    assert _lib.launches["matpow_large"] == 1 and sum(_lib.launches.values()) == 1
    assert torch.equal(tpp._matrix_power_cuda(E, 48), M)
    lam, v = tpp._extract_eigpair(E.to(torch.complex128), M.to(torch.complex128))
    w = tpp._left_vector(M.to(torch.complex128))
    E64 = E.to(torch.complex128)  # the plain version, on the card
    M_p = tpp._matrix_power_plain(E64, 48)
    lam_p, v_p = tpp._extract_eigpair(E64, M_p)
    w_p = tpp._left_vector(M_p)
    lam, v, w, lam_p, v_p, w_p = (to_np(t) for t in (lam, v, w, lam_p, v_p, w_p))
    assert lam[7] == 0 and not v[7].any() and not w[7].any()
    np.testing.assert_allclose(lam, lam_p, atol=2e-5)
    keep = np.arange(B) != 7
    np.testing.assert_allclose(phase_aligned(v[keep], v_p[keep]), v_p[keep], atol=1e-4)
    np.testing.assert_allclose(phase_aligned(w[keep], w_p[keep]), w_p[keep], atol=1e-4)


@pytest.fixture(scope="module")
def forced_libs():
    """This tree's kernels built twice more with every layout forced
    (kernel_ab's variants): "quad" a quad of lanes an element at every
    batch, "thread" one thread an element."""
    require_cuda()
    _lib.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    root = Path(tempfile.mkdtemp(prefix="forced_", dir=_lib.BUILD_DIR))
    try:
        dirs = {k: kernel_ab._variant(_lib.SRC_DIR, k == "quad", k, root) for k in ("thread", "quad")}
        with ThreadPoolExecutor(len(dirs)) as pool:
            paths = dict(zip(dirs, pool.map(lambda d: _lib.build(d, root / "build")[0], dirs.values())))
        yield {k: _lib.load(p) for k, p in paths.items()}
    finally:
        shutil.rmtree(root, ignore_errors=True)


def _k1_plain(E, iters):
    """The complex128 plain solve of E's matrices: lam, v and the left
    vector read off the same power."""
    E64 = E.cpu().to(torch.complex128)
    M = tpp._squarings(E64, iters)
    lam, v = tpp._extract_eigpair(E64, M)
    return lam, v, tpp._left_vector(M)


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1000, 65536])
def test_k1_layouts_match_plain(B):
    """K1 with the left vector at a batch the launcher runs on quads of
    lanes (1,000) and at one it runs one thread an element (65,536),
    against the complex128 plain version: lam to 1e-5, v and w up to phase
    to 1e-4 (chip_smoke.py phase 3's gates); one launch."""
    dev = require_cuda()
    E = torch.from_numpy(transfer_matrices(B, seed=15).astype(np.complex64)).to(dev)
    _lib.reset_launches()
    lam, v, w = tpp._dominant_eig_cuda(E, 40, "squaring", left=True)
    torch.cuda.synchronize()
    assert _lib.launches["dominant_eig"] == 1 and sum(_lib.launches.values()) == 1
    lam_p, v_p, w_p = (to_np(t) for t in _k1_plain(E, 40))
    np.testing.assert_allclose(to_np(lam), lam_p, atol=1e-5)
    np.testing.assert_allclose(phase_aligned(to_np(v), v_p), v_p, atol=1e-4)
    np.testing.assert_allclose(phase_aligned(to_np(w), w_p), w_p, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["thread", "quad"])
def test_k1_forced_layouts_match_plain(layout, forced_libs):
    """K1 forced onto each layout at the represent step's batch (1,024), with
    the left vector, against the complex128 plain version: lam to 1e-5, v
    and w up to phase to 1e-4."""
    dev = require_cuda()
    B = 1024
    E = torch.from_numpy(transfer_matrices(B, seed=16).astype(np.complex64)).to(dev)
    lam = torch.empty(B, dtype=torch.complex64, device=dev)
    v, w = (torch.empty(B, 4, dtype=torch.complex64, device=dev) for _ in range(2))
    rc = forced_libs[layout].qmps_dominant_eig(E.data_ptr(), lam.data_ptr(), v.data_ptr(), w.data_ptr(), B, 40, 0,
                                               torch.cuda.current_stream().cuda_stream)
    _lib.check(rc, "dominant_eig")
    torch.cuda.synchronize()
    lam_p, v_p, w_p = (to_np(t) for t in _k1_plain(E, 40))
    np.testing.assert_allclose(to_np(lam), lam_p, atol=1e-5)
    np.testing.assert_allclose(phase_aligned(to_np(v), v_p), v_p, atol=1e-4)
    np.testing.assert_allclose(phase_aligned(to_np(w), w_p), w_p, atol=1e-4)


@pytest.mark.cuda
def test_eigval_n4_gradient_is_one_k1_launch():
    """dominant_eigval_batched at N = 4 with a gradient: one K1 launch on
    the B matrices E (lam, v and the left vector off one power), none in
    the backward; the value against the complex128 plain version to 1e-5,
    the gradient of sum |lam| against the plain version's to 1e-4 times
    max(1, the element's largest |grad|)."""
    dev = require_cuda()
    B = 1000
    E = torch.from_numpy(transfer_matrices(B, seed=17).astype(np.complex64)).to(dev).requires_grad_()
    _lib.reset_launches()
    lam = tpp.dominant_eigval_batched(E, 48)
    lam.abs().sum().backward()
    torch.cuda.synchronize()
    assert _lib.launches["dominant_eig"] == 1 and sum(_lib.launches.values()) == 1
    E64 = E.detach().cpu().to(torch.complex128).requires_grad_()
    lam_p = tpp.dominant_eigval_batched(E64, 48)
    lam_p.abs().sum().backward()
    np.testing.assert_allclose(to_np(lam), to_np(lam_p), atol=1e-5)
    err = np.abs(to_np(E.grad) - to_np(E64.grad)).reshape(B, -1).max(1)
    scale = np.maximum(1.0, np.abs(to_np(E64.grad)).reshape(B, -1).max(1))
    assert np.all(err <= 1e-4 * scale), (err / scale).max()


def _k6_inputs(B, seed, dev):
    """Seeded QR unitaries (complex64 on the card): U1, U2, U1p, U2p, M, W."""
    rng = np.random.default_rng(seed)

    def hu(*shape):
        Q, _ = np.linalg.qr(rng.standard_normal(shape) + 1j * rng.standard_normal(shape))
        return torch.from_numpy(Q.astype(np.complex64)).to(dev)

    return (*(hu(B, 4, 4) for _ in range(4)), hu(B, 2, 2), hu(16, 16))


@pytest.mark.cuda
def test_k6_views_and_lazy_conjugates():
    """K6 on U2 and U2p as strided views (column 0 not where a contiguous
    tensor keeps it), Ml = M.mH and W as lazy conjugates, and Mr a lazy
    conjugate: every element within 1e-5 of the complex128 plain version
    on the resolved values; one launch."""
    dev = require_cuda()
    B = 777
    U1, U2, U1p, U2p, M, W0 = _k6_inputs(B, 18, dev)
    U2v, U2pv = (u.transpose(1, 2).contiguous().transpose(1, 2) for u in (U2, U2p))
    Mr, Ml, W = M.conj(), M.mH, W0.conj()
    assert not U2v.is_contiguous() and Mr.is_conj() and Ml.is_conj() and W.is_conj()
    _lib.reset_launches()
    out = manifold_overlap_pallas(U1, U2v, U1p, U2pv, Mr, Ml, W)
    torch.cuda.synchronize()
    assert _lib.launches["brickwork_overlap"] == 1 and sum(_lib.launches.values()) == 1
    ref = manifold_overlap_batched(*(t.cpu().resolve_conj().to(torch.complex128) for t in (U1, U2, U1p, U2p, Mr, Ml, W)))
    assert np.abs(to_np(out) - to_np(ref)).max() <= 1e-5


@pytest.mark.cuda
def test_stiefel_sweep_on_the_card_matches_the_cpu():
    """The large-D sweep (D = 8, 16 points, 60 steps, float32) on the card
    against the same sweep in float32 on the CPU, the same starts: energies
    to 1e-4, both never below exact by 1e-4; no hand kernel launches."""
    from qmps_torch.ham.exact import tfim_gs_energy_f64
    from qmps_torch.parallel.sweep import sweep_ground_states_stiefel

    dev = require_cuda()
    gs = torch.linspace(0.3, 1.7, 16, dtype=torch.float32)
    _lib.reset_launches()
    es_c, As_c, _ = sweep_ground_states_stiefel(gs.to(dev), D=8, steps=60)
    torch.cuda.synchronize()
    assert not any(_lib.launches.values())
    es_h, _, _ = sweep_ground_states_stiefel(gs, D=8, steps=60)
    assert es_c.device.type == "cuda" and As_c.dtype == torch.complex64
    np.testing.assert_allclose(to_np(es_c), to_np(es_h), atol=1e-4)
    exact = tfim_gs_energy_f64(to_np(gs).astype(np.float64))
    assert np.all(to_np(es_c) - exact > -1e-4) and np.all(to_np(es_h) - exact > -1e-4)


@pytest.mark.cuda
def test_matvec_fixed_point_on_the_card_matches_the_cpu():
    """right_fixed_point(dense=False) in complex64 on the card: lam and r
    equal the CPU's complex64 run (1e-5, 1e-4) and the dense path's."""
    from qmps_torch.mps.transfer import right_fixed_point

    dev = require_cuda()
    A = torch.from_numpy(left_canonical(np.random.default_rng(4), 1, D=16)[0].astype(np.complex64))
    lam_c, r_c = right_fixed_point(A.to(dev), A.to(dev), dense=False)
    lam_h, r_h = right_fixed_point(A, A, dense=False)
    lam_d, r_d = right_fixed_point(A.to(dev), A.to(dev))
    for lam, r in ((lam_h, r_h), (lam_d, r_d)):
        assert abs(complex(lam_c) - complex(lam)) < 1e-5
        np.testing.assert_allclose(to_np(r_c), to_np(r), atol=1e-4)


@pytest.mark.cuda
def test_vumps_on_the_card_matches_the_cpu():
    """D = 8 VUMPS (TFIM g = 1, 100 iterations, k = 24, complex64) from the
    same seeded A0 on the card and on the CPU: float32 energies within 1e-5
    of each other, both states read back in float64 within (-1e-6, 1e-4)
    of the exact energy, gradient norms below 1e-3; no hand kernel
    launches."""
    from qmps_torch.ham.exact import tfim_gs_energy_f64
    from qmps_torch.mps.imps import random_tensor
    from qmps_torch.mps.tdvp import vumps_ground_state
    from qmps_torch.utils.host_eval import host_energy_gauge_free

    dev = require_cuda()
    A0 = random_tensor(torch.Generator().manual_seed(3), 2, 8, dtype=torch.complex64, device="cpu")
    h = tfim(1.0).to_matrix()
    _lib.reset_launches()
    AL_c, _, e_c, info_c = vumps_ground_state(h, 8, iters=100, A0=A0.to(dev))
    torch.cuda.synchronize()
    assert not any(_lib.launches.values())
    AL_h, _, e_h, info_h = vumps_ground_state(h, 8, iters=100, A0=A0)
    assert AL_c.device.type == "cuda" and AL_c.dtype == AL_h.dtype == torch.complex64
    exact = float(tfim_gs_energy_f64(1.0))
    assert abs(e_c - e_h) < 1e-5, (e_c, e_h)
    for AL, e, info in ((AL_c, e_c, info_c), (AL_h, e_h, info_h)):
        e64 = host_energy_gauge_free(AL, h.real, f32_ref=e)
        assert -1e-6 < e64 - exact < 1e-4, (e64 - exact, e - exact)
        assert float(info["grad_norms"][-1]) < 1e-3, info["grad_norms"][-5:]


@pytest.mark.cuda
def test_odeint_graph_replay_matches_the_cpu():
    """core/ode.odeint on the card replays its step as a CUDA graph (whose
    warm-up runs steps after every row has arrived, which change nothing):
    the scars equations from 8 starts on [0, 3] agree with the CPU's eager
    run to 1e-10, and the rows step independently there too."""
    from qmps_torch.algorithms.scars import classical_rhs
    from qmps_torch.core.ode import odeint

    dev = require_cuda()
    y0s = torch.rand(8, 4, generator=torch.Generator().manual_seed(2), dtype=torch.float64) + 0.3
    ts = torch.linspace(0.0, 3.0, 61, dtype=torch.float64)
    cpu = odeint(lambda y, t: classical_rhs(y, t, 0.325), y0s, ts)
    card = odeint(lambda y, t: classical_rhs(y, t, 0.325), y0s.to(dev), ts.to(dev)).cpu()
    assert (card - cpu).abs().max() < 1e-10
    one = odeint(lambda y, t: classical_rhs(y, t, 0.325), y0s[3:4].to(dev), ts.to(dev)).cpu()
    assert (one[:, 0] - card[:, 3]).abs().max() < 1e-12
