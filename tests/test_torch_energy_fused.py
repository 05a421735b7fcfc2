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
