"""qmps_torch.kernels.energy_fused (kernels K2, K3) against qmps_tpu's
energy_objective_fused: values, gradients (torch's .grad against
conj(jax.grad)), the shared-h broadcast, gradcheck, and the eigenvector
phase fix that the port adds.  Mirrors tests/test_energy_fused.py.

On the CPU the port runs its plain PyTorch versions; the CUDA kernels are
held against them on the card (test_torch_cuda.py).
"""
import jax.numpy as jnp
import numpy as np
import torch

from _torch_parity import assert_parity, left_canonical, tfim_h, to_np
from qmps_torch.algorithms.ground_state import find_ground_state
from qmps_torch.circuits.ansatze import shallow_full_state
from qmps_torch.embed.unitaries import unitary_to_tensor
from qmps_torch.ham.hamiltonian import tfim
from qmps_torch.kernels import energy_fused as tef
from qmps_torch.kernels.pallas_power import _dominant_eig_plain
from qmps_torch.mps.transfer import right_fixed_point
from qmps_tpu.kernels.energy_fused import energy_objective_fused as jax_energy


def _batch(B=5, seed=0):
    return left_canonical(np.random.default_rng(seed), B), tfim_h(np.linspace(0.3, 1.7, B))


def _jax_xla(A, h):
    return jax_energy(A, h, 48, False, "xla")


def _port(A, h):
    return tef.energy_objective_fused(A, h, 48)


def test_forward_and_gradient_match_jax_xla():
    """complex128: energies to 1e-12; dA and dh, torch's against
    conj(jax.grad), to 1e-10 (test_energy_fused.py:57-75)."""
    A, h = _batch()
    assert_parity(_jax_xla, _port, (A, h), atol=1e-12, grad_atol=1e-10)


def test_forward_matches_jax_pallas_interpret():
    """The Pallas forward (interpret mode, f32 planes) against the port's
    complex128 plain version: 2e-5 (test_energy_fused.py:115-123)."""
    A, h = _batch(3)
    e_k = jax_energy(
        jnp.asarray(A.astype(np.complex64)), jnp.asarray(h.astype(np.float32)), 32, True, "pallas"
    )
    e_t = tef.energy_objective_fused(torch.from_numpy(A), torch.from_numpy(h), 48)
    np.testing.assert_allclose(to_np(e_t), np.asarray(e_k), atol=2e-5)


def test_shared_h_broadcast_and_sum():
    """A shared (4, 4) h broadcasts over the batch, and its gradient is the
    batch sum (test_energy_fused.py:78-88), against JAX to 1e-10."""
    A, h = _batch(3)
    assert_parity(_jax_xla, _port, (A, h[1]), atol=1e-12, grad_atol=1e-10)
    At = torch.from_numpy(A)
    h0 = torch.tensor(h[1], requires_grad=True)
    hb = torch.tensor(h[1]).expand(3, 4, 4).clone().requires_grad_()
    tef.energy_objective_fused(At, h0).sum().backward()
    tef.energy_objective_fused(At, hb).sum().backward()
    np.testing.assert_allclose(to_np(h0.grad), to_np(hb.grad.sum(0)), atol=1e-12)


def test_complex_h_gradient_matches_jax():
    """A complex h takes the conjugated cotangent, not its real part."""
    A, h = _batch(3)
    assert_parity(_jax_xla, _port, (A, h.astype(np.complex128)), atol=1e-12, grad_atol=1e-10)


def test_gradcheck():
    """The autograd.Function's backward against finite differences at
    complex128 (B = 2, left-canonical A)."""
    A, h = _batch(2, seed=1)
    args = (torch.tensor(A, requires_grad=True), torch.tensor(h, requires_grad=True))
    assert torch.autograd.gradcheck(lambda a, hh: tef.energy_objective_fused(a, hh, 48), args)


def test_trace_gauge_changes_no_value():
    """The port fixes the eigenvector's phase (tr(v as 2x2) real > 0),
    which the JAX kernels do not: r, e and the adjoint are the same for any
    phase of v (complex128, 1e-12 / 1e-10)."""
    A, h = _batch(4, seed=2)
    At, ht = torch.from_numpy(A), torch.from_numpy(h)
    _, E = tef._build(At)
    lam, v = _dominant_eig_plain(E, 48)
    vg = tef._trace_gauge(v)
    tau = to_np(vg[:, 0] + vg[:, 3])
    np.testing.assert_allclose(tau.imag, 0.0, atol=1e-14)
    assert np.all(tau.real > 0)
    rot = torch.exp(1j * torch.linspace(0.3, 2.9, 4, dtype=torch.float64))[:, None]
    np.testing.assert_allclose(to_np(tef._r_chain(v * rot)[2]), to_np(tef._r_chain(vg)[2]), atol=1e-12)
    ct = torch.ones(4, dtype=torch.float64)
    a1, h1 = tef._bwd_plain(At, ht, lam, vg, ct)
    a2, h2 = tef._bwd_plain(At, ht, lam, v * rot, ct)
    np.testing.assert_allclose(to_np(a1), to_np(a2), atol=1e-10)
    np.testing.assert_allclose(to_np(h1), to_np(h2), atol=1e-12)


def _e_ref_one(A, h):
    """The reference composition of test_energy_fused.py:18-23, batched,
    built from the port's right_fixed_point (its own bordered-solve
    adjoint: an independent derivation of the gradient)."""
    AA = torch.einsum("bsik,btkj->bstij", A, A).reshape(-1, 4, 2, 2)
    _, r = right_fixed_point(AA, AA)
    r = (r + r.mH) / 2
    r = r / r.diagonal(dim1=-2, dim2=-1).sum(-1)[:, None, None]
    return torch.einsum("bts,bsij,bjk,btik->b", h.to(A.dtype), AA, r, AA.conj()).real


def test_near_critical_gradient():
    """At the port's own L-BFGS ground state of tfim(1) (200 steps: the
    subdominant transfer eigenvalue near 1), the plain objective's
    deflated-series gradient against autograd through the reference
    composition, to 1e-8 (test_energy_fused.py:91-112)."""
    gs = find_ground_state(tfim(1.0), D=2, ansatz="full15", method="lbfgs", steps=200, device="cpu")
    As = unitary_to_tensor(shallow_full_state(gs.params))[None]
    hs = torch.from_numpy(tfim_h([1.0]))
    A1, A2 = As.clone().requires_grad_(), As.clone().requires_grad_()
    tef.energy_objective_fused(A1, hs, 48).sum().backward()
    _e_ref_one(A2, hs).sum().backward()
    np.testing.assert_allclose(to_np(A1.grad), to_np(A2.grad), atol=1e-8)


def _k2_quad(As, hs, iters):
    """K2's quad layout (``csrc/energy_fused.cu::energy_fwd_quad_kernel``)
    emulated, batched over elements: lane r holds row r of E and of its
    power; each squaring forms row r of M^2 as sum_k M[r, k] M[k, :] and
    the Frobenius norm as the two-step butterfly; the reads gather the
    power and E; the energy is split by t = r and summed by the butterfly.
    -> e, lam, v as K2 stores them."""
    from qmps_torch.kernels.pallas_power import _chirp_read

    AA, E = tef._build(As)
    rows = [E[:, r, :] for r in range(4)]
    for _ in range(iters):
        rows = [sum((rows[r][:, k, None] * rows[k] for k in range(4)), torch.zeros_like(rows[r]))
                for r in range(4)]
        n = [(x.real.square() + x.imag.square()).sum(-1) for x in rows]
        n = [n[r] + n[r ^ 1] for r in range(4)]
        n = [n[r] + n[r ^ 2] for r in range(4)]
        rows = [rows[r] * torch.rsqrt(torch.clamp(n[r], min=1e-30))[:, None] for r in range(4)]
    v = _chirp_read(torch.stack(rows, 1))
    lam = (v.conj() * (E @ v[..., None])[..., 0]).sum(-1)
    v = tef._trace_gauge(v)
    _, _, r2 = tef._r_chain(v)
    T = torch.einsum("bsij,bjk,btik->bts", AA, r2, AA.conj())
    part = [(hs[:, t, :].to(T.dtype) * T[:, t, :]).sum(-1).real for t in range(4)]
    part = [part[r] + part[r ^ 1] for r in range(4)]
    return part[0] + part[2], lam, v


def test_k2_quad_map_matches_plain():
    """K2's quad map against the plain forward ``_fwd_plain``: at complex128
    to 1e-12; in complex64 arithmetic (the card's) against complex128
    within chip_smoke.py phase 4's gates: e 2e-5, lam 1e-5, v 1e-4 (v is
    phase-fixed, so compared as is)."""
    A, h = _batch(33, seed=4)
    At, ht = torch.from_numpy(A), torch.from_numpy(h)
    want = tef._fwd_plain(At, ht, 48)
    for got, ref in zip(_k2_quad(At, ht, 48), want):
        np.testing.assert_allclose(to_np(got), to_np(ref), atol=1e-12)
    e, lam, v = _k2_quad(At.to(torch.complex64), ht.to(torch.complex64), 48)
    assert e.dtype == torch.float32 and lam.dtype == v.dtype == torch.complex64
    np.testing.assert_allclose(to_np(e), to_np(want[0]), atol=2e-5)
    np.testing.assert_allclose(to_np(lam), to_np(want[1]), atol=1e-5)
    np.testing.assert_allclose(to_np(v), to_np(want[2]), atol=1e-4)


def _quad_sum(parts):
    """The quad's two-round butterfly over four lanes' values: (p0 + p1) +
    (p2 + p3) on every lane."""
    return (parts[0] + parts[1]) + (parts[2] + parts[3])


def _k3_quad(As, hs, lam, v, ct):
    """K3's quad layout (``csrc/energy_fused.cu::energy_bwd_quad_kernel``)
    emulated, batched over elements.  Lane r writes row t = r of hbar and
    forms the t = r part of r2bar, which the butterfly sums; it owns x[r]
    and row r of X, built from column r of E with the deflation, and each
    doubling gathers x for the matvec and forms row r of X^2 as sum_k X[r, k]
    X[k, :]; after the series it forms G's two-site slot r = (s1 s2) and
    that slot's part of every Abar entry through the AA build (the first
    sum at (s, t) = (s1, s2), the second at (t, s) = (s1, s2)), which the
    butterfly sums.  -> (Abar, hbar) as K3 stores them."""
    AA, E = tef._build(As)
    r1, tau, r2 = tef._r_chain(v)
    ctc, h_, AAc = ct.to(As.dtype), hs.to(As.dtype), AA.conj()
    M = torch.einsum("bsij,bjk->bsik", AA, r2)
    hbar = torch.stack([torch.einsum("bsik,bik->bs", M, AAc[:, r]) for r in range(4)], 1) * ctc[:, None, None]
    r2bar = ctc[:, None, None] * _quad_sum(
        [torch.einsum("bs,bsij,bik->bjk", h_[:, r], AA, AAc[:, r]) for r in range(4)])
    inner = torch.einsum("bjk,bjk->b", r2bar, r1)
    eye = torch.eye(2, dtype=As.dtype)
    r1bar = r2bar / tau[:, None, None] - (inner / tau**2)[:, None, None] * eye
    q = ((r1bar + r1bar.mH) / 2.0).reshape(-1, 4)
    vw = v[:, 0] + v[:, 3]
    alpha = (v * q).sum(-1) / vw
    x = [q[:, r] - (alpha if r in (0, 3) else 0) for r in range(4)]
    rows = [(E[:, :, r] - (lam / vw)[:, None] * v * (r in (0, 3))) / lam[:, None] for r in range(4)]
    for _ in range(tef.SERIES_K):
        x = [x[r] + sum(rows[r][:, j] * x[j] for j in range(4)) for r in range(4)]
        rows = [sum(rows[r][:, k, None] * rows[k] for k in range(4)) for r in range(4)]
    z = (torch.stack(x, 1) / lam[:, None]).reshape(-1, 2, 2)
    v2 = v.reshape(-1, 2, 2)
    parts = []
    for r in range(4):
        g = torch.einsum("b,bt,bjk,btik->bij", ctc, h_[:, :, r], r2, AAc)  # direct slot 1, s = r
        g = g + torch.einsum("b,bs,bsik->bik", ctc, h_[:, r], M).conj()  # direct slot 2, t = r
        g = g + torch.einsum("bij,bkl,bjl->bik", z, v2, AAc[:, r])  # Ebar through the ket
        g = g + torch.einsum("bij,bkl,bik->bjl", z, v2, AA[:, r]).conj()  # and through the bra
        s1, s2 = r >> 1, r & 1
        o = torch.zeros_like(As)
        o[:, s1] += torch.einsum("bpj,bcj->bpc", g, As[:, s2])
        o[:, s2] += torch.einsum("bic,bip->bpc", g, As[:, s1])
        parts.append(o)
    return _quad_sum(parts), hbar


def test_k3_quad_map_matches_plain():
    """K3's quad map against the plain adjoint ``_bwd_plain`` on K2's
    outputs, with a cotangent that varies by element: at complex128 to
    1e-12; in complex64 arithmetic (the card's) against complex128 within
    chip_smoke.py phase 4's gates: hbar 3e-4, Abar 3e-4 times max(1, the
    element's largest |Abar|)."""
    A, h = _batch(33, seed=5)
    At, ht = torch.from_numpy(A), torch.from_numpy(h)
    _, lam, v = tef._fwd_plain(At, ht, 48)
    ct = torch.linspace(0.5, 1.5, 33, dtype=torch.float64)
    Abar_p, hbar_p = tef._bwd_plain(At, ht, lam, v, ct)
    for got, ref in zip(_k3_quad(At, ht, lam, v, ct), (Abar_p, hbar_p)):
        np.testing.assert_allclose(to_np(got), to_np(ref), atol=1e-12)
    c64 = torch.complex64
    Abar, hbar = _k3_quad(At.to(c64), ht.to(c64), lam.to(c64), v.to(c64), ct.float())
    assert Abar.dtype == hbar.dtype == c64
    np.testing.assert_allclose(to_np(hbar), to_np(hbar_p), atol=3e-4)
    err = np.abs(to_np(Abar) - to_np(Abar_p)).reshape(33, -1).max(1)
    scale = np.maximum(1.0, np.abs(to_np(Abar_p)).reshape(33, -1).max(1))
    assert np.all(err <= 3e-4 * scale), (err / scale).max()
