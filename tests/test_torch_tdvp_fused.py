"""qmps_torch.kernels.tdvp_fused (kernels K4, K5) and the overlap
objectives against qmps_tpu: the plain forward against the dense
objective and against the Pallas kernel in interpret mode, the rank-1
adjoint (torch's .grad against conj(jax.grad)) for a shared and a batched
gate, gradcheck, and the exact Loschmidt rate.  Mirrors
tests/test_tdvp_fused.py.

On the CPU the port runs its plain PyTorch versions; the CUDA kernels are
held against them on the card (test_torch_cuda.py).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.linalg
import torch

from _torch_parity import assert_parity, left_canonical, nearest_isometry, phase_aligned, to_np
from qmps_torch.ham.exact import loschmidt_rate
from qmps_torch.kernels import tdvp_fused as ttf
from qmps_torch.kernels.pallas_power import _dominant_eig_plain
from qmps_torch.objectives import overlap as tov
from qmps_tpu.ham import exact as jexact
from qmps_tpu.kernels.tdvp_fused import _fused_forward as jax_fused_forward
from qmps_tpu.kernels.tdvp_fused import tdvp_objective_fused as jax_fused
from qmps_tpu.objectives.overlap import tdvp_objective as jax_dense


def _batch(B, seed):
    """Random (unnormalized) tensors scaled to Frobenius norm 2, as
    tests/test_tdvp_fused.py:18-26 makes them."""
    rng = np.random.default_rng(seed)
    As, Bs = (rng.standard_normal((B, 2, 2, 2)) + 1j * rng.standard_normal((B, 2, 2, 2)) for _ in range(2))
    scale = lambda x: x / np.linalg.norm(x.reshape(B, -1), axis=1)[:, None, None, None] * 2
    return scale(As), scale(Bs)


def _W(seed, B=None):
    """expm(-0.05 i H) of a random real symmetric H: one gate or a batch."""
    rng = np.random.default_rng(seed)
    Hs = rng.standard_normal((B or 1, 4, 4))
    Ws = np.stack([scipy.linalg.expm(-0.05j * (h + h.T)) for h in Hs])
    return Ws if B else Ws[0]


def _jax_dense(As, Bs, W):
    if W.ndim == 3:
        return jax.vmap(jax_dense)(As, Bs, W)
    return jax.vmap(lambda a, b: jax_dense(a, b, W))(As, Bs)


@pytest.mark.parametrize("batched_w", [False, True])
def test_plain_forward_matches_dense_objective(batched_w):
    """The plain K4 (squaring from the chirps) against vmap(tdvp_objective)
    (squaring from vec(I)), complex128: 1e-10."""
    As, Bs = _batch(5, 0)
    W = _W(1, 5 if batched_w else None)
    got = ttf.tdvp_objective_fused(*(torch.from_numpy(x) for x in (As, Bs, W)))
    np.testing.assert_allclose(to_np(got), np.asarray(_jax_dense(As, Bs, W)), atol=1e-10)


def test_plain_forward_matches_pallas_interpret():
    """The JAX kernel in interpret mode (float32 planes, B = 2, 8
    squarings) against the port's plain version at complex128: 5e-5
    (test_tdvp_fused.py:37-42)."""
    As, Bs = _batch(2, 2)
    W = _W(3)
    want = jax_fused(jnp.asarray(As), jnp.asarray(Bs), jnp.asarray(W.astype(np.complex64)), 8, True)
    got = ttf.tdvp_objective_fused(*(torch.from_numpy(x) for x in (As, Bs, W)), iters=48)
    np.testing.assert_allclose(to_np(got), np.asarray(want), atol=5e-5)


@pytest.mark.parametrize("batched_w", [False, True])
def test_gradients_match_dense_objective(batched_w):
    """dA, dB and dW of the summed objective, torch's against conj(jax.grad)
    of the dense objective, complex128: 1e-8; a shared W's gradient is the
    batch sum."""
    As, Bs = _batch(3, 4)
    W = _W(5, 3 if batched_w else None)
    assert_parity(_jax_dense, ttf.tdvp_objective_fused, (As, Bs, W), atol=1e-10, grad_atol=1e-8)


def test_dense_port_matches_dense_objective():
    """The port's own dense tdvp_objective (the quench's engine="dense")
    against JAX's, value and gradients, batched W: 1e-10."""
    As, Bs = _batch(3, 6)
    assert_parity(_jax_dense, tov.tdvp_objective, (As, Bs, _W(7, 3)), atol=1e-12, grad_atol=1e-10)


def test_real_w_takes_the_real_gradient():
    """A real W gets a real cotangent: the real part of the complex one."""
    As, Bs = (torch.from_numpy(x) for x in _batch(2, 8))
    Wr = torch.tensor(np.random.default_rng(9).standard_normal((4, 4)), requires_grad=True)
    Wc = Wr.detach().to(torch.complex128).requires_grad_()
    ttf.tdvp_objective_fused(As, Bs, Wr).sum().backward()
    ttf.tdvp_objective_fused(As, Bs, Wc).sum().backward()
    assert Wr.grad.dtype == torch.float64
    np.testing.assert_allclose(to_np(Wr.grad), to_np(Wc.grad).real, atol=1e-12)


def test_gradcheck():
    """The autograd.Function's backward against finite differences at
    complex128, B = 2, batched W."""
    As, Bs = _batch(2, 10)
    args = tuple(torch.tensor(x, requires_grad=True) for x in (As, Bs, _W(11, 2)))
    assert torch.autograd.gradcheck(ttf.tdvp_objective_fused, args)


def test_left_vector_only_when_a_gradient_is_taken():
    """Without a gradient the forward skips the E^dag solve; with one, w is
    the left eigenvector (w^dag E = lam w^dag, up to phase)."""
    As, Bs = (torch.from_numpy(x) for x in _batch(3, 12))
    W = torch.from_numpy(_W(13))
    _, _, _, E = ttf._build(As, Bs, W.expand(3, 4, 4))
    lam, v, w = ttf._fwd_plain(As, Bs, W.expand(3, 4, 4), 48, True)
    assert ttf._fwd_plain(As, Bs, W.expand(3, 4, 4), 48, False)[2] is None
    np.testing.assert_allclose(to_np((w.conj()[:, None, :] @ E)[:, 0]), to_np(lam[:, None] * w.conj()), atol=1e-12)
    lv, V = np.linalg.eig(to_np(E))
    k = np.argmax(np.abs(lv), axis=1)
    v_np = np.stack([V[b, :, k[b]] for b in range(3)])
    np.testing.assert_allclose(phase_aligned(to_np(v), v_np), v_np, atol=1e-12)


def _quench_like(B, seed):
    """Left-canonical A and B the nearest isometry to A + 0.05 noise (a
    clear spectral gap), W a random gate: float32 solves are well posed."""
    rng = np.random.default_rng(seed)
    A = left_canonical(rng, B)
    Bt = nearest_isometry(A + 0.05 * (rng.standard_normal(A.shape) + 1j * rng.standard_normal(A.shape)))
    return A, Bt, _W(seed + 1)


def test_left_vector_is_one_chain_equal_to_two():
    """The plain K4's left vector, read off the conjugate transpose of E's
    power, equals the dominant eigenvector of a second complex128 chain on
    E^dag (the JAX kernel's way, and K4's before), up to phase: 1e-12."""
    As, Bs, W = (torch.from_numpy(x) for x in _quench_like(6, 16))
    Wb = W.expand(6, 4, 4)
    _, _, _, E = ttf._build(As, Bs, Wb)
    _, _, w = ttf._fwd_plain(As, Bs, Wb, 48, True)
    w2 = _dominant_eig_plain(E.mH, 48)[1]
    print(f"|u off M^dag - u of a second chain| {np.abs(phase_aligned(to_np(w), to_np(w2)) - to_np(w2)).max():.3g}")
    np.testing.assert_allclose(phase_aligned(to_np(w), to_np(w2)), to_np(w2), atol=1e-12)


def test_left_vector_matches_pallas_interpret():
    """The plain K4's lam, v and left vector u against JAX's fused forward
    with the left solve, in interpret mode (float32 planes, 48
    squarings): lam to 2e-5, v and u up to phase to 1e-5."""
    As, Bs, W = _quench_like(3, 18)
    lam_j, v_j, u_j = (np.asarray(x) for x in jax_fused_forward(
        jnp.asarray(As), jnp.asarray(Bs), jnp.asarray(W.astype(np.complex64)), 48, True, interpret=True))
    lam, v, u = ttf._fwd_plain(*(torch.from_numpy(x) for x in (As, Bs)), torch.from_numpy(W).expand(3, 4, 4),
                               48, True)
    np.testing.assert_allclose(to_np(lam), lam_j, atol=2e-5)
    np.testing.assert_allclose(phase_aligned(to_np(v), v_j), v_j, atol=1e-5)
    print(f"|u - JAX's u| {np.abs(phase_aligned(to_np(u), u_j) - u_j).max():.3g}")
    np.testing.assert_allclose(phase_aligned(to_np(u), u_j), u_j, atol=1e-5)


def test_pallas_dispatch_shape_checks():
    """tdvp_objective_pallas: the JAX package's shape errors
    (test_evolve.py:65-80); D > 2 takes the K7/K8 path, where zero tensors
    give a finite zero; D = 2 is the fused objective."""
    A = torch.zeros(1, 2, 4, 4, dtype=torch.complex128)
    with pytest.raises(ValueError, match="4, 4"):
        tov.tdvp_objective_pallas(A, A, torch.eye(16), iters=2)
    with pytest.raises(ValueError, match="batched"):
        tov.tdvp_objective_pallas(A[0], A[0], torch.eye(4), iters=2)
    np.testing.assert_array_equal(to_np(tov.tdvp_objective_pallas(A, A, torch.eye(4), iters=2)), [0.0])
    As, Bs = (torch.from_numpy(x) for x in _batch(2, 14))
    W = torch.from_numpy(_W(15))
    np.testing.assert_array_equal(to_np(tov.tdvp_objective_pallas(As, Bs, W, 48)),
                                  to_np(ttf.tdvp_objective_fused(As, Bs, W, 48)))


def test_loschmidt_rate_matches_jax():
    for g0, g1 in ((1.5, 0.2), (0.5, 1.8)):
        for t in (0.05, 0.6, 1.7):
            np.testing.assert_allclose(loschmidt_rate(t, g0, g1), float(jexact.loschmidt_rate(t, g0, g1)),
                                       atol=1e-10)
    t = np.linspace(0.0, 1.0, 5)
    np.testing.assert_allclose(loschmidt_rate(t, 1.5, 0.2), [loschmidt_rate(x, 1.5, 0.2) for x in t], atol=1e-15)


def _k5_lanes(As, Bs, Wb, lam, v, u, ct):
    """K5's 16-lane layout (``csrc/tdvp_fused.cu::tdvp_bwd_lanes_kernel``)
    emulated, batched over elements: each stage a 16-entry tile, lane l
    forming entry l from the tiles of the stage before, in the kernel's
    stage order and index maps.  -> (Abar, Bbar, Wbar) as K5 stores them."""
    a, bt, w = As.reshape(-1, 8), Bs.reshape(-1, 8), Wb.reshape(-1, 16)
    n2 = lam.real.square() + lam.imag.square()
    d = (u.conj() * v).sum(-1)
    dn = 1.0 / torch.clamp(d.real.square() + d.imag.square(), min=1e-30)
    coef = (-ct * dn) * (torch.rsqrt(torch.clamp(n2, min=1e-30)) * lam.conj() * d.conj())
    cu = coef[:, None] * u.conj()
    zero = torch.zeros_like(lam)
    aa, bb, waa, P, C, Wbar, Q = ([None] * 16 for _ in range(7))
    for l in range(16):  # AA[l], BB[l], WAA[l]: each lane builds AA[t, q4] for all t
        s, hi, lo = l >> 2, (l >> 1) & 1, l & 1
        aat = [a[:, (t >> 1) * 4 + hi * 2] * a[:, (t & 1) * 4 + lo]
               + a[:, (t >> 1) * 4 + hi * 2 + 1] * a[:, (t & 1) * 4 + 2 + lo] for t in range(4)]
        aa[l] = aat[s]
        waa[l] = sum((w[:, s * 4 + t] * aat[t] for t in range(4)), zero)
        bb[l] = bt[:, (s >> 1) * 4 + hi * 2] * bt[:, (s & 1) * 4 + lo] \
            + bt[:, (s >> 1) * 4 + hi * 2 + 1] * bt[:, (s & 1) * 4 + 2 + lo]
    for l in range(16):  # P[s, i = hi, k = lo], C[s, j = hi, l' = lo]
        s, hi, lo = l >> 2, (l >> 1) & 1, l & 1
        P[l] = sum((cu[:, hi * 2 + j] * sum((v[:, lo * 2 + l2] * bb[s * 4 + j * 2 + l2].conj() for l2 in range(2)), zero)
                    for j in range(2)), zero)
        C[l] = sum((cu[:, i * 2 + hi] * sum((v[:, k * 2 + lo] * waa[s * 4 + i * 2 + k] for k in range(2)), zero)
                    for i in range(2)), zero).conj()
    for l in range(16):  # Wbar[s, t = q4], Q[t = s, ik = q4]
        s, q4 = l >> 2, l & 3
        Wbar[l] = sum((P[s * 4 + ik] * aa[q4 * 4 + ik] for ik in range(4)), zero)
        Q[l] = sum((P[s2 * 4 + q4] * w[:, s2 * 4 + s] for s2 in range(4)), zero)
    bars = []
    for l in range(16):  # lanes 0-7 Abar (Q, A), lanes 8-15 Bbar (C, B)
        g, x = (Q, a) if l < 8 else (C, bt)
        o = l & 7
        so, p, c = o >> 2, (o >> 1) & 1, o & 1
        acc = zero
        for t in range(2):
            for j in range(2):
                acc = acc + g[(so * 2 + t) * 4 + p * 2 + j] * x[:, t * 4 + c * 2 + j]
            for i in range(2):
                acc = acc + g[(t * 2 + so) * 4 + i * 2 + c] * x[:, t * 4 + i * 2 + p]
        bars.append(acc)
    stack = lambda xs: torch.stack(xs, -1)
    return stack(bars[:8]).reshape(-1, 2, 2, 2), stack(bars[8:]).reshape(-1, 2, 2, 2), stack(Wbar).reshape(-1, 4, 4)


@pytest.mark.parametrize("batched_w", [False, True])
def test_k5_lane_map_matches_plain(batched_w):
    """K5's lane map against the plain adjoint ``_bwd_plain``: at complex128
    to 1e-12; in complex64 arithmetic (the card's) against complex128 within
    chip_smoke.tdvp_check's gate, 2e-4 times max(1, the element's largest
    |bar|), on quench-like inputs and a cotangent that varies by element."""
    B = 33
    A, Bt, W = _quench_like(B, 20)
    Wb = torch.from_numpy(W).expand(B, 4, 4) if not batched_w else torch.from_numpy(
        np.stack([_W(30 + b) for b in range(B)]))
    As, Bs = torch.from_numpy(A), torch.from_numpy(Bt)
    lam, v, u = ttf._fwd_plain(As, Bs, Wb, 48, True)
    ct = torch.linspace(0.5, 1.5, B, dtype=torch.float64)
    want = ttf._bwd_plain(As, Bs, Wb, lam, v, u, ct)
    for got, ref in zip(_k5_lanes(As, Bs, Wb, lam, v, u, ct), want):
        np.testing.assert_allclose(to_np(got), to_np(ref), atol=1e-12)
    c64 = torch.complex64
    got32 = _k5_lanes(*(t.to(c64) for t in (As, Bs, Wb, lam, v, u)), ct.float())
    for got, ref in zip(got32, want):
        err = np.abs(to_np(got).astype(np.complex128) - to_np(ref)).reshape(B, -1).max(1)
        scale = np.maximum(1.0, np.abs(to_np(ref)).reshape(B, -1).max(1))
        assert got.dtype == c64 and np.all(err <= 2e-4 * scale), (err / scale).max()
