"""qmps_torch's batched eigensolve for N = D^2 > 4 (the plain versions of
kernels K7 and K8), ``dominant_eigval_batched`` and the D >= 3 dispatch of
``tdvp_objective_pallas``, against qmps_tpu (its Pallas kernels in
interpret mode, and its dense objective), numpy eig and finite
differences.  Mirrors tests/test_pallas.py:104-196.

The JAX kernels run in float32 (they cast to it even under x64), so parity
with them holds at the float32 floor; parity with numpy and the dense
objective is at complex128.  On the CPU the port runs its plain versions;
the CUDA kernels are held against them on the card (test_torch_cuda.py).
"""
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.linalg
import torch

from _torch_parity import left_canonical, nearest_isometry, phase_aligned, tfim_h, to_np
from qmps_torch.kernels import _lib
from qmps_torch.kernels import pallas_power as tpp
from qmps_torch.mps.transfer import dominant_eigval_dense
from qmps_torch.objectives.overlap import tdvp_objective_pallas
from qmps_tpu.kernels import pallas_power as jpp
from qmps_tpu.objectives import overlap as jov


def _random(N, B=6, seed=7):
    """Complex normals scaled by 1/sqrt(N) (tests/test_pallas.py:110-113):
    complex spectra of radius ~1, batch 6 a multiple of no pack or block."""
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, N, N)) + 1j * rng.standard_normal((B, N, N))) / np.sqrt(N)


def _numpy_dominant(E):
    w, V = np.linalg.eig(E)
    i = np.argmax(np.abs(w), axis=1)
    return w[np.arange(len(E)), i], V[np.arange(len(E)), :, i]


def _tdvp_inputs(B, D, seed, batched_w):
    """Left-canonical A, B the nearest isometry to A + 0.03 noise
    (tests/test_pallas.py:143-161), and W = expm(-i h(g1) 0.04) per element
    for g1 in [0.1, 0.4], or one shared expm(-0.1 i h(1))."""
    rng = np.random.default_rng(seed)
    A = left_canonical(rng, B, D)
    Bt = nearest_isometry(A + 0.03 * (rng.standard_normal(A.shape) + 1j * rng.standard_normal(A.shape)))
    if batched_w:
        W = np.stack([scipy.linalg.expm(-0.04j * h) for h in tfim_h(rng.uniform(0.1, 0.4, B))])
    else:
        W = scipy.linalg.expm(-0.1j * tfim_h(1.0))
    return A, Bt, W


def _jax_dense(As, Bs, W):
    if W.ndim == 3:
        return jax.vmap(jov.tdvp_objective)(As, Bs, W)
    return jax.vmap(lambda a, b: jov.tdvp_objective(a, b, W))(As, Bs)


@pytest.mark.parametrize("N", [9, 16, 25, 64, 81, 256])
def test_plain_matches_jax_interpret(N):
    """complex64 plain version against the JAX kernels in interpret mode
    (K7's at N = 9, 16; K8's at 25, 64, with its block-diagonal pack and
    padding, and at 81, 256, the N > 64 sizes the port's K8 squares over
    tiles): lam to 2e-5, v up to its phase to 1e-5 (the phase of
    lam^(2^iters) is arbitrary in float32)."""
    E = _random(N).astype(np.complex64)
    lam_j, v_j = jpp.dominant_eig_batched(jnp.asarray(E), iters=48, interpret=True)
    lam_t, v_t = tpp.dominant_eig_batched(torch.from_numpy(E), iters=48)
    assert lam_t.dtype == torch.complex64 and v_t.shape == (6, N)
    np.testing.assert_allclose(to_np(lam_t), np.asarray(lam_j), atol=2e-5)
    np.testing.assert_allclose(phase_aligned(to_np(v_t), np.asarray(v_j)), np.asarray(v_j), atol=1e-5)


@pytest.mark.parametrize("N", [9, 16, 25, 64, 81, 256])
def test_plain_matches_numpy_eig(N):
    """complex128 plain version against numpy eig: lam and v (up to phase)
    to 1e-10."""
    E = _random(N, seed=N)
    lam, v = tpp.dominant_eig_batched(torch.from_numpy(E))
    lam_n, v_n = _numpy_dominant(E)
    np.testing.assert_allclose(to_np(lam), lam_n, atol=1e-10)
    np.testing.assert_allclose(phase_aligned(to_np(v), v_n), v_n, atol=1e-10)


def test_matrix_power_is_normalised_and_zero_stays_finite():
    """The plain K7/K8 steps: the power has unit Frobenius norm, is rank one
    at convergence (M = v w^dag / ... up to phase), and a zero matrix gives
    a zero power and lam = 0, v = 0 through the clamped norms, not NaN; no
    launch on the CPU."""
    E = _random(9, B=3, seed=1)
    E[1] = 0
    _lib.reset_launches()
    M = tpp._matrix_power_plain(torch.from_numpy(E), 48)
    lam, v = tpp.dominant_eig_batched(torch.from_numpy(E))
    assert not any(_lib.launches.values())
    norms = np.linalg.norm(to_np(M), axis=(1, 2))
    np.testing.assert_allclose(norms[[0, 2]], 1.0, atol=1e-12)
    assert norms[1] == 0 and to_np(lam)[1] == 0 and np.all(to_np(v)[1] == 0)
    s = np.linalg.svd(to_np(M)[[0, 2]], compute_uv=False)
    assert np.all(s[:, 1] < 1e-12)


def test_method_power_above_n4_raises():
    with pytest.raises(ValueError, match="squaring"):
        tpp.dominant_eig_batched(torch.from_numpy(_random(9)), method="power")
    with pytest.raises(ValueError, match="method"):
        tpp.dominant_eig_batched(torch.from_numpy(_random(9)), method="arnoldi")


def test_eigval_gradcheck():
    """The rank-1 adjoint against finite differences, complex128, N = 9,
    B = 3."""
    E = torch.from_numpy(_random(9, B=3, seed=2)).requires_grad_()
    assert torch.autograd.gradcheck(lambda x: tpp.dominant_eigval_batched(x, 48), (E,))


def test_eigval_gradient_matches_jax_and_dense():
    """Gradient of sum |lam| (N = 9, B = 3): against conj(jax.grad) of
    JAX's dominant_eigval_batched in interpret mode (float32 inside) to
    1e-5, and against the port's dense eigenvalue adjoint to 1e-10."""
    E = _random(9, B=3, seed=3)
    Et = torch.from_numpy(E).requires_grad_()
    tpp.dominant_eigval_batched(Et, 48).abs().sum().backward()
    gj = jax.grad(lambda x: jnp.sum(jnp.abs(jpp.dominant_eigval_batched(x, 48, True))))(jnp.asarray(E))
    np.testing.assert_allclose(to_np(Et.grad), np.conj(np.asarray(gj)), atol=1e-5)
    Ed = torch.from_numpy(E).requires_grad_()
    dominant_eigval_dense(Ed).abs().sum().backward()
    np.testing.assert_allclose(to_np(Et.grad), to_np(Ed.grad), atol=1e-10)


@pytest.mark.parametrize("N", [4, 16])
def test_eigval_solves_once_with_both_vectors(N, monkeypatch):
    """With a gradient the forward squares E alone, once, and reads both
    eigenvectors off that power (not a power of [E, E^dag] on 2B matrices;
    at N = 4 as K1 does in one launch on the card); without one, E alone
    too: both give the same eigenvalues."""
    E = torch.from_numpy(_random(N, B=4, seed=4))
    calls, power = [], tpp._squarings
    monkeypatch.setattr(tpp, "_squarings", lambda x, iters: calls.append(x.shape[0]) or power(x, iters))
    with torch.no_grad():
        lam0 = tpp.dominant_eigval_batched(E)
    lam1 = tpp.dominant_eigval_batched(E.clone().requires_grad_())
    assert calls == [4, 4]
    np.testing.assert_allclose(to_np(lam1), to_np(lam0), atol=1e-12)


@pytest.mark.parametrize("N", [4, 9, 16, 64])
def test_saved_left_vector_matches_jax(N):
    """The left eigenvector the forward saves, read off the power's
    conjugate transpose, against the w of JAX's forward, which squares
    [E, E^dag] in interpret mode (float32 kernels; at N = 4 its K1 solve of
    the 2B matrices): up to phase, 1e-5."""
    E = _random(N, seed=20 + N).astype(np.complex64)
    lam = tpp.dominant_eigval_batched(torch.from_numpy(E).requires_grad_(), 48)
    v, w = lam.grad_fn.saved_tensors
    lam_j, (v_j, w_j, _) = jpp._dom_eigval_batched_fwd(jnp.asarray(E), 48, True)
    np.testing.assert_allclose(to_np(lam), np.asarray(lam_j), atol=2e-5)
    np.testing.assert_allclose(phase_aligned(to_np(v), np.asarray(v_j)), np.asarray(v_j), atol=1e-5)
    print(f"N = {N}: |w - JAX's w| {np.abs(phase_aligned(to_np(w), np.asarray(w_j)) - np.asarray(w_j)).max():.3g}")
    np.testing.assert_allclose(phase_aligned(to_np(w), np.asarray(w_j)), np.asarray(w_j), atol=1e-5)


@pytest.mark.parametrize("N", [4, 9, 64])
def test_left_vector_off_the_power_equals_a_second_chain(N):
    """complex128: w read off M^dag equals the dominant eigenvector of a
    separate squaring chain on E^dag (1e-12 up to phase) and is E's left
    eigenvector (w^dag E = lam w^dag, 1e-10)."""
    E = torch.from_numpy(_random(N, seed=30 + N))
    M = tpp._matrix_power_plain(E, 48)
    lam, _ = tpp._extract_eigpair(E, M)
    w = tpp._left_vector(M)
    w2 = tpp._extract_eigpair(E.mH, tpp._matrix_power_plain(E.mH, 48))[1]
    diff = np.abs(phase_aligned(to_np(w), to_np(w2)) - to_np(w2)).max()
    print(f"N = {N}: |w off M^dag - w of a second chain| {diff:.3g}")
    np.testing.assert_allclose(phase_aligned(to_np(w), to_np(w2)), to_np(w2), atol=1e-12)
    np.testing.assert_allclose(to_np((w.conj()[:, None, :] @ E)[:, 0]), to_np(lam[:, None] * w.conj()), atol=1e-10)


@pytest.mark.parametrize("batched_w", [False, True])
@pytest.mark.parametrize("D", [3, 4, 8, 9])
def test_tdvp_objective_pallas_larger_D(D, batched_w):
    """tdvp_objective_pallas at D >= 3 (B = 2): values against JAX's
    tdvp_objective_pallas in interpret mode (float32 kernels) to 2e-5 and
    against the JAX dense objective at complex128 to 1e-10; the Bs-gradient
    of the sum against conj(jax.grad) of the dense objective to 1e-8."""
    As, Bs, W = _tdvp_inputs(2, D, 10 * D + batched_w, batched_w)
    Bt = torch.from_numpy(Bs).requires_grad_()
    val = tdvp_objective_pallas(torch.from_numpy(As), Bt, torch.from_numpy(W))
    assert val.shape == (2,) and val.dtype == torch.float64
    want_p = jov.tdvp_objective_pallas(jnp.asarray(As), jnp.asarray(Bs), jnp.asarray(W), 48, True)
    np.testing.assert_allclose(to_np(val), np.asarray(want_p), atol=2e-5)
    np.testing.assert_allclose(to_np(val), np.asarray(_jax_dense(As, Bs, W)), atol=1e-10)
    val.sum().backward()
    gd = jax.grad(lambda b: jnp.sum(_jax_dense(jnp.asarray(As), b, jnp.asarray(W))))(jnp.asarray(Bs))
    np.testing.assert_allclose(to_np(Bt.grad), np.conj(np.asarray(gd)), atol=1e-8)


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32's 10 mantissa bits, to nearest with ties away
    from zero (PTX cvt.rna.tf32.f32)."""
    return ((x.view(torch.int32) + 0x1000) & ~0x1FFF).view(torch.float32)


def _tf32_power(E: torch.Tensor, iters: int, split: bool) -> torch.Tensor:
    """K7's and K8's squaring on the tensor cores, emulated: float32 planes R, I,
    the three real products RR, II and SS (S = R + I) with TF32 operands
    and float32 sums, re = RR - II, im = SS - RR - II, the Frobenius norm
    after every squaring.  ``split``: 3xTF32 (x = hi + lo, hi hi + hi lo +
    lo hi); else one pass on the rounded operands."""
    def product(X):
        hi = _tf32(X)
        if not split:
            return hi @ hi
        lo = _tf32(X - hi)
        return hi @ lo + lo @ hi + hi @ hi

    def normalised(R, I):
        inv = torch.rsqrt(torch.clamp((R * R + I * I).sum((-2, -1), keepdim=True), min=1e-30))
        return R * inv, I * inv

    R, I = normalised(E.real.float(), E.imag.float())
    for _ in range(iters):
        RR, II, SS = product(R), product(I), product(R + I)
        R, I = normalised(RR - II, SS - RR - II)
    return torch.complex(R, I).to(E.dtype)


def _padded(N: int) -> int:
    """The size the kernels pad N to: a multiple of 16 up to 64 (K7, K8's
    tensor-core blocks), of 64 above (K8's tiles)."""
    return -(-N // 16) * 16 if N <= tpp.MAX_SHARED_N else -(-N // tpp.TILE) * tpp.TILE


@pytest.mark.parametrize("N", [9, 16, 64, 81, 256])
def test_k8_tensor_core_numerics(N):
    """Why K7 and K8 square in 3xTF32 and never in one-pass TF32 (ROADMAP,
    "Numerics follow the reference"): 48 random N x N matrices (8 at
    N = 256), zero-padded as the kernels pad them (N = 9 to 16, 81 to 128),
    48 squarings, the pair read off each emulated power against the
    complex128 plain version.  3xTF32 stays within 2e-6 in lam and v (up
    to phase); one-pass TF32 misses the card's 2e-5 gate on lam
    (chip_smoke.py).  At N = 81 and 256 this is the prediction for phase
    11's gates on K8's tiles, made before their first chip run."""
    B = 8 if N > 128 else 48
    E = torch.from_numpy(_random(N, B=B, seed=5))
    lam_p, v_p = tpp._extract_eigpair(E, tpp._matrix_power_plain(E, 48))
    NP = _padded(N)
    Ep = torch.zeros(B, NP, NP, dtype=E.dtype)
    Ep[:, :N, :N] = E
    errs = {}
    for split in (True, False):
        lam, v = tpp._extract_eigpair(E, _tf32_power(Ep, 48, split)[:, :N, :N])
        errs[split] = (np.abs(to_np(lam - lam_p)).max(),
                       np.abs(phase_aligned(to_np(v), to_np(v_p)) - to_np(v_p)).max())
    print(f"N = {N}: 3xTF32 lam {errs[True][0]:.3g} v {errs[True][1]:.3g}; one-pass TF32 lam {errs[False][0]:.3g} "
          f"v {errs[False][1]:.3g}")
    assert max(errs[True]) < 2e-6
    assert errs[False][0] > 2e-5


def _tiles_power(E: torch.Tensor, iters: int) -> torch.Tensor:
    """K8's schedule above N = 64 (csrc/matpow.cu::launch_tiles), emulated
    in float32: E split into planes R, I (zero-padded to a multiple of 64)
    and not normalised; each 64 x 64 tile's partial ||.||^2, summed in tile
    order; every squaring computes RR, II and SS in 3xTF32 with S = R + I
    summed from the stored planes (bitwise the plane an epilogue would have
    written), scales re = RR - II and im = SS - RR - II by c = 1 / max(n2,
    1e-30) of the previous power (the norm folded in, no pass of its own),
    and the output pass scales the last product by rsqrt(max(n2, 1e-30))."""
    N = E.shape[-1]
    NP = -(-N // tpp.TILE) * tpp.TILE
    R = torch.zeros(E.shape[0], NP, NP, dtype=torch.float32)
    I = torch.zeros_like(R)
    R[:, :N, :N], I[:, :N, :N] = E.real.float(), E.imag.float()

    def product(X):
        hi = _tf32(X)
        lo = _tf32(X - hi)
        return hi @ lo + lo @ hi + hi @ hi

    def norm2(R, I):
        T = NP // tpp.TILE
        tiles = (R * R + I * I).reshape(-1, T, tpp.TILE, T, tpp.TILE).sum((2, 4)).reshape(-1, T * T)
        n2 = tiles[:, 0]
        for k in range(1, T * T):
            n2 = n2 + tiles[:, k]
        return torch.clamp(n2, min=1e-30)[:, None, None]

    for _ in range(iters):
        c = 1 / norm2(R, I)
        RR, II, SS = product(R), product(I), product(R + I)
        R, I = c * (RR - II), c * (SS - RR - II)
    s = torch.rsqrt(norm2(R, I))
    return torch.complex(s * R, s * I)[:, :N, :N].to(E.dtype)


@pytest.mark.parametrize("N", [81, 256])
def test_k8_tiles_schedule_matches_plain(N):
    """K8's tiles above N = 64 emulated step for step (``_tiles_power``:
    the S plane from the stored planes, the norm folded into the next
    squaring, 3xTF32) against the complex128 plain version on 16 random
    matrices (8 at N = 256) and a zero one: lam and v (up to phase) within
    2e-6, the zero matrix's power zero and finite; and the same schedule
    with iters = 0 is E / ||E||_F."""
    B = 8 if N > 128 else 16
    E = torch.from_numpy(_random(N, B=B, seed=9))
    E[3] = 0
    M = _tiles_power(E, 48)
    assert torch.isfinite(torch.view_as_real(M)).all() and not M[3].any()
    lam_p, v_p = tpp._extract_eigpair(E, tpp._matrix_power_plain(E, 48))
    lam, v = tpp._extract_eigpair(E, M)
    keep = np.arange(B) != 3
    err_lam = np.abs(to_np(lam - lam_p)).max()
    err_v = np.abs(phase_aligned(to_np(v)[keep], to_np(v_p)[keep]) - to_np(v_p)[keep]).max()
    print(f"N = {N}: K8's tile schedule, 3xTF32, lam {err_lam:.3g} v {err_v:.3g}")
    assert err_lam < 2e-6 and err_v < 2e-6
    np.testing.assert_allclose(to_np(_tiles_power(E, 0)), to_np(tpp._matrix_power_plain(E, 0)), atol=1e-7)


def _small_maps() -> dict:
    """csrc/matpow.cu's ``small_map``, read off the source: N -> (LP, LD,
    GAP, ES), matpow_small_kernel's lanes an element and the layout of its
    power in shared memory."""
    src = (Path(tpp.__file__).resolve().parents[1] / "csrc" / "matpow.cu").read_text()
    body = src[src.index("constexpr SmallMap small_map(int n)"):]
    body = body[:body.index("\n}\n")]
    four = r"\{(\d+), (\d+), (\d+), (\d+)\};"
    out = {int(n): tuple(int(x) for x in v) for n, *v in re.findall(r"case (\d+): return " + four, body)}
    out[16] = tuple(int(x) for x in re.search(r"default: return " + four, body).groups())
    return out


def _fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """float32 a b + c rounded once (the product is exact in float64; the
    sum rounds there first, a double rounding the kernel's FFMA does not
    make, rarely and below this file's tolerances)."""
    return (a.double() * b.double() + c.double()).float()


def _small_power(E: torch.Tensor, iters: int) -> torch.Tensor:
    """matpow_small_kernel (csrc/matpow.cu, K7 below kMatpowTcMinN)
    emulated step for step in float32.  LP lanes an element; the power is
    zero-padded to 2 BM x CG BN (CG = LP / 2, BM = ceil(N / 2), BN =
    ceil(N / CG)) and lane q owns block (q // CG, q % CG); each product
    entry takes its four FMAs (``cmac``: re += ar br, re -= ai bi, im +=
    ar bi, im += ai br) in k order; ``block_norm2`` sums a lane's block row
    by row (a row's entries in order, re then im), the rows in order, then
    the xor butterfly over the element's lanes (1, 2, ...).  Y = E / ||E||,
    then iters times Y = c Y Y with c = r r, r = rsqrt(max(||Y||^2,
    1e-30)) of the stored Y (the norm folded into the next squaring); the
    output Y rsqrt(max(||Y||^2, 1e-30))."""
    N, B = E.shape[-1], E.shape[0]
    LP, LD, GAP, ES = _small_maps()[N]
    CG = LP // 2
    BM, BN = -(-N // 2), -(-N // CG)
    assert LP in (4, 8) and LD % 2 == GAP % 2 == ES % 2 == 0 and LD >= CG * BN and ES >= 2 * BM * LD + GAP
    R = torch.zeros(B, 2 * BM, CG * BN)
    I = torch.zeros_like(R)
    R[:, :N, :N], I[:, :N, :N] = E.real.float(), E.imag.float()
    lane = torch.arange(LP)

    def norm2(R, I):
        Rb, Ib = R.reshape(B, 2, BM, CG, BN), I.reshape(B, 2, BM, CG, BN)
        n2 = torch.zeros(B, 2, CG)
        for t in range(BM):
            p = torch.zeros(B, 2, CG)
            for u in range(BN):
                p = _fma(Rb[:, :, t, :, u], Rb[:, :, t, :, u], p)
                p = _fma(Ib[:, :, t, :, u], Ib[:, :, t, :, u], p)
            n2 = n2 + p
        lanes = n2.reshape(B, LP)
        m = 1
        while m < LP:
            lanes = lanes + lanes[:, lane ^ m]
            m <<= 1
        assert torch.equal(lanes, lanes[:, :1].expand(B, LP))  # every lane the same bits
        return lanes[:, 0, None, None]

    def rsqrt(n2):
        return torch.rsqrt(torch.clamp(n2, min=1e-30))

    s = rsqrt(norm2(R, I))
    R, I = s * R, s * I
    n2 = norm2(R, I)
    for _ in range(iters):
        aR, aI = torch.zeros_like(R), torch.zeros_like(I)
        for k in range(N):
            ar, ai, br, bi = R[:, :, k:k + 1], I[:, :, k:k + 1], R[:, k:k + 1], I[:, k:k + 1]
            aR = _fma(-ai, bi, _fma(ar, br, aR))
            aI = _fma(ai, br, _fma(ar, bi, aI))
        r = rsqrt(n2)
        c = r * r
        R, I = c * aR, c * aI
        n2 = norm2(R, I)
    assert not R[:, N:].any() and not R[:, :, N:].any()  # the padding stays zero
    s = rsqrt(n2)
    return torch.complex(s * R, s * I)[:, :N, :N]


def _jax_component_power(E: np.ndarray, iters: int) -> np.ndarray:
    """JAX's K7, ``_matrix_power_batched_component`` in interpret mode, on
    a complex64 batch laid out as its caller lays it out (component-major
    planes, the batch padded with zeros to 8 x 128)."""
    B, N = E.shape[0], E.shape[-1]
    Bp = -(-B // 1024) * 1024
    comp = np.zeros((N * N, Bp), np.complex64)
    comp[:, :B] = E.reshape(B, N * N).T
    planes = [jnp.asarray(x.reshape(N, N, Bp // 128, 128)) for x in (comp.real, comp.imag)]
    Mre, Mim = jpp._matrix_power_batched_component(*planes, iters, tile_rows=8, interpret=True)
    M = np.asarray(Mre).reshape(N * N, Bp) + 1j * np.asarray(Mim).reshape(N * N, Bp)
    return M.T[:B].reshape(B, N, N)


@pytest.mark.parametrize("N", range(5, 13))
def test_k7_small_schedule_matches_plain_and_jax(N):
    """matpow_small_kernel's lane blocks and schedule, emulated
    (``_small_power``), on 16 random matrices and a zero one, 48
    squarings: lam and v (up to phase) within 2e-6 of the complex128 plain
    version and of JAX's interpret-mode K7, all read through the same
    complex128 extract; the zero matrix's power zero and finite; iters = 0
    is E / ||E||_F."""
    E = torch.from_numpy(_random(N, B=17, seed=30 + N).astype(np.complex64))
    E[3] = 0
    M = _small_power(E, 48)
    assert torch.isfinite(torch.view_as_real(M)).all() and not M[3].any()
    E64 = E.to(torch.complex128)
    lam, v = tpp._extract_eigpair(E64, M.to(torch.complex128))
    keep = np.arange(17) != 3
    for tag, ref in (("plain", tpp._matrix_power_plain(E64, 48)),
                     ("JAX", torch.from_numpy(_jax_component_power(E.numpy(), 48)).to(torch.complex128))):
        lam_r, v_r = tpp._extract_eigpair(E64, ref)
        err_lam = np.abs(to_np(lam - lam_r)).max()
        err_v = np.abs(phase_aligned(to_np(v)[keep], to_np(v_r)[keep]) - to_np(v_r)[keep]).max()
        print(f"N = {N}: matpow_small_kernel's schedule against the {tag} power: lam {err_lam:.3g} v {err_v:.3g}")
        assert err_lam < 2e-6 and err_v < 2e-6, tag
    np.testing.assert_allclose(to_np(_small_power(E, 0)), to_np(tpp._matrix_power_plain(E64, 0)), atol=1e-7)


def test_matpow_work_floats_counts_the_tiles_workspace():
    """The wrapper's workspace for K8 above N = 64: two sets of R, I planes
    padded to a multiple of 64, and two sets of the tiles' partial norms."""
    assert tpp.matpow_work_floats(133, 256) == 2 * (133 * 2 * 256 * 256 + 133 * 16)
    assert tpp.matpow_work_floats(5, 81) == 2 * (5 * 2 * 128 * 128 + 5 * 4)


def _phase_11_random_64():
    """chip_smoke.py phase 11's 1,001 random 64 x 64 matrices (element 5
    zero), rounded to complex64 as the card holds them: the same
    np.random.default_rng(11) stream, drawn in the phase's order (the
    D = 4 and D = 8 TDVP pairs of 4,096, then N = 9, 16, 25)."""
    rng = np.random.default_rng(11)
    for D in (4, 8):
        for shape in ((4096, 2 * D, D),) * 2 + ((4096, 2, D, D),) * 2:
            rng.standard_normal(shape)
        rng.uniform(0.1, 0.4, 4096)
    for N in (9, 16, 25, 64):
        E = (rng.standard_normal((1001, N, N)) + 1j * rng.standard_normal((1001, N, N))) / np.sqrt(N)
    E[5] = 0
    return torch.from_numpy(E.astype(np.complex64))


def test_k8_emulation_with_the_cards_complex64_read():
    """K8's 3xTF32 squaring emulated on phase 11's own inputs, with (lam, v)
    read in complex64 as the card reads them (``dominant_eig_batched`` on a
    complex64 E and power), against the complex128 plain version: lam
    7.8e-7, v 1.45e-6 up to phase (the complex128 read of the same power
    gives 8.8e-7 and 1.45e-6; a complex64 read of the complex128 power
    alone 5.2e-7 and 2.8e-7).  So the read does not explain the card's v
    error of 2.76e-6: over 1,001 matrices the emulation reaches half of it,
    and the rest is the card's own summation inside the tensor-core
    products, which PyTorch's float32 matmul does not reproduce."""
    E32 = _phase_11_random_64()
    E = E32.to(torch.complex128)
    lam_p, v_p = tpp._extract_eigpair(E, tpp._matrix_power_plain(E, 48))
    M = _tf32_power(E32, 48, True)
    lam, v = tpp._extract_eigpair(E32, M)
    keep = np.arange(E.shape[0]) != 5
    err_lam = np.abs(to_np(lam.to(torch.complex128) - lam_p)).max()
    v, v_p = to_np(v).astype(np.complex128)[keep], to_np(v_p)[keep]
    err_v = np.abs(phase_aligned(v, v_p) - v_p).max()
    print(f"3xTF32, complex64 read, 1,001 random 64 x 64: lam {err_lam:.3g} v {err_v:.3g}")
    assert to_np(lam)[5] == 0 and 5e-7 < err_lam < 1.2e-6
    assert 1.2e-6 < err_v < 1.8e-6
