"""qmps_torch.mps.transfer and objectives.energy against qmps_tpu's at
complex128: the dense transfer matrix, the right fixed point, the
eigenvalue with its rank-1 adjoint, and the exact-environment energy of
the full15 state with its gradient in the real parameters (torch's .grad
against conj(jax.grad), which for a real parameter is jax.grad itself);
gradcheck on both custom adjoints."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import assert_parity, left_canonical, phase_aligned, tfim_h, to_np
from qmps_torch.circuits.ansatze import shallow_full_state
from qmps_torch.core.linalg import _chirp, dominant_eig_dense, rotate_to_hermitian
from qmps_torch.mps import transfer as ttr
from qmps_torch.objectives.energy import energy_exact_env
from qmps_tpu.circuits import ansatze as jans
from qmps_tpu.core import linalg as jlin
from qmps_tpu.mps import transfer as jtr
from qmps_tpu.objectives import energy as jenergy


def _pair(B=4, seed=0):
    """Left-canonical A and B near A (the nearest isometry to A + 0.3
    noise), as TDVP pairs them: the mixed transfer matrix then has a
    gapped dominant eigenvalue, which two random tensors need not have
    (then no squaring solve converges and its vector is rounding noise)."""
    rng = np.random.default_rng(seed)
    A = left_canonical(rng, B)
    x = A.transpose(0, 2, 1, 3).reshape(B, 4, 2)
    x = x + 0.3 * (rng.standard_normal(x.shape) + 1j * rng.standard_normal(x.shape))
    U, _, Vh = np.linalg.svd(x, full_matrices=False)
    return A, (U @ Vh).reshape(B, 2, 2, 2).transpose(0, 2, 1, 3).copy()


def _E(B=4, seed=0):
    A, Bt = _pair(B, seed)
    return np.asarray(jax.vmap(jtr.transfer_dense)(jnp.asarray(A), jnp.asarray(Bt)))


def test_transfer_dense_and_right_fixed_point_match_jax():
    A, Bt = _pair()
    E_j = np.asarray(jax.vmap(jtr.transfer_dense)(jnp.asarray(A), jnp.asarray(Bt)))
    E_t = to_np(ttr.transfer_dense(torch.from_numpy(A), torch.from_numpy(Bt)))
    np.testing.assert_allclose(E_t, E_j, atol=1e-12)
    r0 = np.random.default_rng(1).standard_normal((4, 2, 2)) + 0j
    np.testing.assert_allclose(
        to_np(ttr.right_matvec(*(torch.from_numpy(x) for x in (A, Bt, r0)))),
        np.asarray(jax.vmap(jtr.right_matvec)(jnp.asarray(A), jnp.asarray(Bt), jnp.asarray(r0))),
        atol=1e-12,
    )
    for X, Y in ((A, Bt), (A, A)):
        lam_j, r_j = jax.vmap(jtr.right_fixed_point)(jnp.asarray(X), jnp.asarray(Y))
        lam_t, r_t = ttr.right_fixed_point(torch.from_numpy(X), torch.from_numpy(Y))
        np.testing.assert_allclose(to_np(lam_t), np.asarray(lam_j), atol=1e-10)
        np.testing.assert_allclose(to_np(r_t), np.asarray(r_j), atol=1e-10)


def test_dense_eigensolve_and_hermitian_rotation_match_jax():
    E = _E(3, seed=2)
    lam_j, v_j = jax.vmap(jlin.dominant_eig_dense)(jnp.asarray(E))
    lam_t, v_t = dominant_eig_dense(torch.from_numpy(E))
    np.testing.assert_allclose(to_np(lam_t), np.asarray(lam_j), atol=1e-12)
    # the phase of v is that of lam^(2^40): rounding in lam's phase, times 2^40
    np.testing.assert_allclose(phase_aligned(to_np(v_t), np.asarray(v_j)), np.asarray(v_j), atol=1e-12)
    r = v_j.reshape(3, 2, 2) * np.exp(1j * np.array([0.4, 2.0, -2.9]))[:, None, None]
    np.testing.assert_allclose(to_np(rotate_to_hermitian(torch.from_numpy(np.asarray(r)))),
                               np.asarray(jax.vmap(jlin.rotate_to_hermitian)(r)), atol=1e-12)
    np.testing.assert_allclose(to_np(_chirp(5, torch.complex128)), np.asarray(jlin._chirp(5, jnp.complex128)))


@pytest.mark.parametrize("readout", ["abs", "re_rotated"])
def test_dominant_eigval_dense_value_and_gradient(readout):
    """A real readout of lam (|lam|, or Re(c lam) with a complex c, which
    a conjugation slip would flip): value and dE against JAX to 1e-10."""
    c = 0.6 - 0.8j

    def jax_fn(E):
        lam = jax.vmap(jtr.dominant_eigval_dense)(E)
        return jnp.abs(lam) if readout == "abs" else jnp.real(c * lam)

    def torch_fn(E):
        lam = ttr.dominant_eigval_dense(E)
        return lam.abs() if readout == "abs" else (c * lam).real

    assert_parity(jax_fn, torch_fn, (_E(),), atol=1e-12, grad_atol=1e-10)


def test_energy_exact_env_value_and_parameter_gradient():
    """The full15 state's exact-environment energy and its gradient in the
    real parameters (the quench's and find_ground_state's loss), 1e-10."""
    p = np.random.default_rng(5).uniform(-np.pi, np.pi, (3, 15))
    h = tfim_h([0.5, 1.0, 1.5])
    assert_parity(
        lambda p_, h_: jax.vmap(lambda q, hh: jenergy.energy_exact_env(jans.shallow_full_state(q), hh))(p_, h_),
        lambda p_, h_: energy_exact_env(shallow_full_state(p_), h_),
        (p, h), atol=1e-12, grad_atol=1e-10,
    )


def test_gradcheck_of_the_two_adjoints():
    E = torch.tensor(_E(2, seed=6), requires_grad=True)
    assert torch.autograd.gradcheck(ttr.dominant_eigval_dense, (E,))
    c = _chirp(4, torch.complex128)
    assert torch.autograd.gradcheck(lambda e: ttr.dominant_eigpair_cgauge(e, c), (E,))
