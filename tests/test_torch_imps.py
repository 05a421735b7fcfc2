"""qmps_torch.mps.imps and the left fixed point against qmps_tpu at
complex128: the gauge helpers, left_orthogonalise, iMPS.left_canonicalise
for 1- and 2-site cells, iMPS.overlap and Map, to 1e-10 (the canonical
forms are compared directly: both packages fix the same QR / Cholesky
gauge)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import to_np
from qmps_torch.mps import imps as timps
from qmps_torch.mps import transfer as ttr
from qmps_tpu.mps import imps as jimps
from qmps_tpu.mps import transfer as jtr


def _tensor(seed, d=2, D=2):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((d, D, D)) + 1j * rng.standard_normal((d, D, D))


@pytest.mark.parametrize("D", [2, 3])
def test_left_fixed_point_matches_jax(D):
    A, B = _tensor(1, 2, D), _tensor(2, 2, D)
    l0 = np.random.default_rng(3).standard_normal((D, D)) + 0j
    np.testing.assert_allclose(
        to_np(ttr.left_matvec(*(torch.from_numpy(x) for x in (A, B, l0)))),
        np.asarray(jtr.left_matvec(jnp.asarray(A), jnp.asarray(B), jnp.asarray(l0))), atol=1e-12)
    for X, Y in ((A, A), (A, B)):
        lam_j, l_j = jtr.left_fixed_point(jnp.asarray(X), jnp.asarray(Y))
        lam_t, l_t = ttr.left_fixed_point(torch.from_numpy(X), torch.from_numpy(Y))
        np.testing.assert_allclose(complex(lam_t), complex(lam_j), atol=1e-10)
        np.testing.assert_allclose(to_np(l_t), np.asarray(l_j), atol=1e-10)


def test_gauge_helpers_match_jax():
    rng = np.random.default_rng(4)
    X = rng.standard_normal((3, 3)) + 1j * rng.standard_normal((3, 3))
    P = X @ X.conj().T
    np.testing.assert_allclose(to_np(timps._cholesky_psd(torch.from_numpy(P))),
                               np.asarray(jimps._cholesky_psd(jnp.asarray(P))), atol=1e-12)
    for t, j in zip(timps._qr_pos(torch.from_numpy(X)), jimps._qr_pos(jnp.asarray(X))):
        np.testing.assert_allclose(to_np(t), np.asarray(j), atol=1e-12)
    # rank-deficient: the cutoff drops the null direction in both
    S = np.diag([1.0, 0.5, 1e-15]).astype(np.complex128)
    np.testing.assert_allclose(to_np(timps._pinv_tri(torch.from_numpy(S))),
                               np.asarray(jimps._pinv_tri(jnp.asarray(S))), atol=1e-12)


@pytest.mark.parametrize("d,D", [(2, 2), (4, 2), (2, 4)])
def test_left_orthogonalise_matches_jax(d, D):
    A = _tensor(d * 10 + D, d, D)
    AL_t, M_t, eta_t = timps.left_orthogonalise(torch.from_numpy(A))
    AL_j, M_j, eta_j = jimps.left_orthogonalise(jnp.asarray(A))
    np.testing.assert_allclose(to_np(AL_t), np.asarray(AL_j), atol=1e-10)
    np.testing.assert_allclose(to_np(M_t), np.asarray(M_j), atol=1e-10)
    np.testing.assert_allclose(complex(eta_t), complex(eta_j), atol=1e-10)
    AL = to_np(AL_t)
    np.testing.assert_allclose(np.einsum("sik,sil->kl", AL.conj(), AL), np.eye(D), atol=1e-10)


@pytest.mark.parametrize("n", [1, 2])
def test_left_canonicalise_matches_jax(n):
    """1- and 2-site cells: each returned tensor as JAX's, left-canonical."""
    data = [_tensor(20 + k) for k in range(n)]
    st = timps.iMPS([torch.from_numpy(a) for a in data])
    sj = jimps.iMPS([jnp.asarray(a) for a in data])
    assert len(st) == n and st.d == 2 and st.D == 2
    np.testing.assert_allclose(to_np(st.blocked), np.asarray(sj.blocked), atol=1e-12)
    ct, cj = st.left_canonicalise(), sj.left_canonicalise()
    assert len(ct) == n
    for k in range(n):
        np.testing.assert_allclose(to_np(ct[k]), np.asarray(cj[k]), atol=1e-10)
        AL = to_np(ct[k])
        np.testing.assert_allclose(np.einsum("sik,sil->kl", AL.conj(), AL), np.eye(2), atol=1e-10)


def test_overlap_and_map_match_jax():
    A, B = _tensor(30, 4, 2), _tensor(31, 4, 2)
    ov_t = timps.iMPS([torch.from_numpy(A)]).overlap(timps.iMPS([torch.from_numpy(B)]))
    ov_j = jimps.iMPS([jnp.asarray(A)]).overlap(jimps.iMPS([jnp.asarray(B)]))
    np.testing.assert_allclose(float(ov_t), float(ov_j), atol=1e-10)
    assert abs(float(timps.iMPS([torch.from_numpy(A)]).overlap(timps.iMPS([torch.from_numpy(A)]))) - 1) < 1e-10
    m_t, m_j = timps.Map(torch.from_numpy(A), torch.from_numpy(B)), jimps.Map(jnp.asarray(A), jnp.asarray(B))
    np.testing.assert_allclose(to_np(m_t.asmatrix()), np.asarray(m_j.asmatrix()), atol=1e-12)
    for t, j in zip(m_t.right_fixed_point(), m_j.right_fixed_point()):
        np.testing.assert_allclose(to_np(t), np.asarray(j), atol=1e-10)
