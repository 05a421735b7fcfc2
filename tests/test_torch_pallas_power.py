"""qmps_torch.kernels.pallas_power (kernel K1) against qmps_tpu's
dominant_eig_batched and against numpy eig.

On the CPU the port runs its plain PyTorch version; the CUDA kernel is
held against that plain version on the card (test_torch_cuda.py).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import phase_aligned, to_np, transfer_matrices
from qmps_torch.kernels import _lib
from qmps_torch.kernels import pallas_power as tpp
from qmps_torch.kernels.pallas_power import dominant_eig_batched
from qmps_tpu.kernels import pallas_power as jpp


@pytest.mark.parametrize("method,iters", [("squaring", 40), ("power", 96)])
def test_plain_matches_jax_interpret(method, iters):
    """Same f32 algorithm as the Pallas kernel (interpret mode): lam to
    1e-5.  v too, compared up to its global phase for the squaring solve:
    there v carries the phase of lam^(2^iters), which f32 rounding in
    either implementation makes arbitrary."""
    E = transfer_matrices(8, seed=0).astype(np.complex64)
    lam_j, v_j = jpp.dominant_eig_batched(jnp.asarray(E), iters=iters, interpret=True, method=method)
    lam_t, v_t = dominant_eig_batched(torch.from_numpy(E), iters=iters, method=method)
    lam_j, v_j, v_t = np.asarray(lam_j), np.asarray(v_j), to_np(v_t)
    np.testing.assert_allclose(to_np(lam_t), lam_j, atol=1e-5)
    if method == "squaring":
        v_t = phase_aligned(v_t, v_j)
    np.testing.assert_allclose(v_t, v_j, atol=1e-5)


def test_plain_matches_numpy_eig():
    """complex128 plain version against dense eig on random (non-physical,
    complex-spectrum) matrices: lam and v (up to phase) to 1e-10."""
    rng = np.random.default_rng(3)
    E = (rng.standard_normal((8, 4, 4)) + 1j * rng.standard_normal((8, 4, 4))) / 2
    lam, v = dominant_eig_batched(torch.from_numpy(E), iters=48)
    w, vecs = np.linalg.eig(E)
    i = np.argmax(np.abs(w), axis=1)
    ref_v = vecs[np.arange(8), :, i]
    np.testing.assert_allclose(to_np(lam), w[np.arange(8), i], atol=1e-10)
    np.testing.assert_allclose(phase_aligned(to_np(v), ref_v), ref_v, atol=1e-10)


def test_k1_three_product_chain_in_float32():
    """K1's squaring as its one-thread kernel forms it (csrc/pallas_power.cu::
    matsq4_3p: float32 planes R, I, the three real products RR, II and
    (R + I)(R + I), re = RR - II, im = SS - RR - II, the Frobenius norm
    after each of 40 squarings), then lam, v and the left vector w read off
    the power in complex64, against the complex128 plain version on 4,096
    transfer matrices of seeded left-canonical D = 2 tensors:
    chip_smoke.py phase 3's gates, |dlam| < 1e-5, |dv| and |dw| up to phase
    < 1e-4, ||lam| - 1| < 1e-5."""
    E = torch.from_numpy(transfer_matrices(4096, seed=0))
    M_p = tpp._squarings(E, 40)
    lam_p, v_p = tpp._extract_eigpair(E, M_p)
    w_p = tpp._left_vector(M_p)
    E32 = E.to(torch.complex64)
    R, I = E32.real.contiguous(), E32.imag.contiguous()
    for _ in range(40):
        RR, II, SS = R @ R, I @ I, (R + I) @ (R + I)
        R, I = RR - II, SS - RR - II
        inv = torch.rsqrt(torch.clamp((R * R + I * I).sum((-2, -1), keepdim=True), min=1e-30))
        R, I = R * inv, I * inv
    M = torch.complex(R, I)
    lam, v = tpp._extract_eigpair(E32, M)
    w = tpp._left_vector(M)
    errs = (np.abs(to_np(lam) - to_np(lam_p)).max(), np.abs(phase_aligned(to_np(v), to_np(v_p)) - to_np(v_p)).max(),
            np.abs(phase_aligned(to_np(w), to_np(w_p)) - to_np(w_p)).max(), np.abs(np.abs(to_np(lam)) - 1).max())
    print("three-product chain, complex64: |dlam| {:.3g}, |dv| {:.3g}, |dw| {:.3g}, ||lam|-1| {:.3g}".format(*errs))
    assert errs[0] < 1e-5 and errs[1] < 1e-4 and errs[2] < 1e-4 and errs[3] < 1e-5


def test_cpu_tensor_runs_plain_version():
    """A CPU tensor never touches the kernel library or its counters (N = 4
    and, through the K7/K8 path, N = 9, where a zero matrix stays finite);
    unknown methods raise."""
    _lib.reset_launches()
    E = torch.from_numpy(transfer_matrices(4, seed=1))
    lam, v = dominant_eig_batched(E)
    assert lam.dtype == torch.complex128 and v.shape == (4, 4)
    np.testing.assert_allclose(np.abs(to_np(lam)), 1.0, atol=1e-12)
    assert _lib.launches["dominant_eig"] == 0
    lam9, v9 = dominant_eig_batched(torch.zeros(2, 9, 9, dtype=torch.complex128))
    assert v9.shape == (2, 9) and not lam9.any() and not v9.any()
    assert not any(_lib.launches.values())
    with pytest.raises(ValueError, match="method"):
        dominant_eig_batched(E, method="arnoldi")


def test_missing_compiler_raises(monkeypatch):
    """No nvcc: building the kernel library raises instead of returning
    nothing (what a CUDA tensor would reach)."""
    monkeypatch.setenv("PATH", "")
    monkeypatch.setenv("CUDA_HOME", "/nonexistent")
    monkeypatch.setattr(_lib, "library_path", lambda *dirs: _lib.BUILD_DIR / "absent.so")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _lib.build()

