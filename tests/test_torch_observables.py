"""qmps_torch.mps.imps's observables and canonical forms against qmps_tpu
at complex128 (tests/test_imps.py, tests/test_correlations.py): one- and
two-site expectation values (Y included), the right and mixed gauges,
Schmidt values, entropy, truncation, correlators, the correlation length,
the structure factor, Map and TransferMatrix; and the phase of r, which
the port removes before it hermitizes."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import to_np
from qmps_torch.core.paulis import X, Y, Z
from qmps_torch.mps import imps as timps
from qmps_torch.mps import transfer as ttr
from qmps_tpu.mps import imps as jimps

ATOL = 1e-10
OPS = {"X": X, "Y": Y, "Z": Z}


def _tensor(seed, d=2, D=2):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((d, D, D)) + 1j * rng.standard_normal((d, D, D))


def _pair(data):
    return timps.iMPS([torch.from_numpy(a) for a in data]), jimps.iMPS([jnp.asarray(a) for a in data])


def _close(t, j, atol=ATOL):
    np.testing.assert_allclose(to_np(t) if isinstance(t, torch.Tensor) else t, np.asarray(j), rtol=0, atol=atol)


@pytest.mark.parametrize("n,D", [(1, 2), (1, 3), (2, 2)])
def test_expectation_values_match_jax(n, D):
    """E (canonical or not), Es, E2 and energy to 1e-10, with Y (the
    "ts,sij,jk,tik" pairing: the other order computes <op^T>)."""
    st, sj = _pair([_tensor(40 + k, 2, D) for k in range(n)])
    d = 2 ** n
    for name, op in OPS.items():
        op_n = np.kron(op.numpy(), np.eye(d // 2))
        _close(st.E(torch.from_numpy(op_n)), sj.E(op_n))
        _close(st.E(torch.from_numpy(op_n), canonical=False), sj.E(op_n, canonical=False))
    ops = [np.kron(o.numpy(), np.eye(d // 2)) for o in OPS.values()]
    _close(st.Es([torch.from_numpy(o) for o in ops]), sj.Es(ops))
    h = np.random.default_rng(7).standard_normal((d * d, d * d))
    h = h + h.T + 1j * (np.tril(np.ones((d * d, d * d)), -1) - np.triu(np.ones((d * d, d * d)), 1))
    _close(st.E2(torch.from_numpy(h)), sj.E2(h))
    _close(st.energy(torch.from_numpy(h)), sj.energy(h))
    Yn = torch.kron(Y, torch.eye(d // 2, dtype=Y.dtype))
    assert abs(complex(st.E(Yn)) - complex(st.E(Yn.T))) > 1e-3  # the pairing matters for Y


def test_phase_of_r_is_removed_before_hermitizing(monkeypatch):
    """A squaring solve may return r times any phase.  At pi/2 the JAX
    package's (r + r^dag)/2 is zero and its trace too: the observables
    become NaN.  The port rotates r first and returns JAX's values."""
    st, sj = _pair([_tensor(50, 2, 3)])
    want = [complex(sj.E(op.numpy())) for op in OPS.values()] + [complex(sj.E2(np.kron(Z, Z)))]
    solve = ttr.right_fixed_point

    def rotated(A, B, dense=True, iters=40):
        lam, r = solve(A, B, dense, iters)
        return lam, 1j * r  # a phase of pi/2

    monkeypatch.setattr(timps.tr, "right_fixed_point", rotated)
    got = [complex(st.E(op)) for op in OPS.values()] + [complex(st.E2(torch.kron(Z, Z)))]
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    np.testing.assert_allclose(to_np(st.Es(list(OPS.values()))), np.real(want[:3]), rtol=0, atol=ATOL)
    r = to_np(solve(*(st.left_canonicalise()[0],) * 2)[1]) * 1j
    assert np.abs((r + r.conj().T) / 2).max() < 1e-15  # what the plain average would have left


def test_product_state_expectations():
    """tests/test_imps.py:135-143: cos(a)|0> + sin(a)|1> per site."""
    a = 0.37
    A = torch.zeros(2, 1, 1, dtype=torch.complex128)
    A[0, 0, 0], A[1, 0, 0] = np.cos(a), np.sin(a)
    psi = timps.iMPS([A])
    assert abs(float(psi.E(Z).real) - np.cos(2 * a)) < 1e-12 and abs(float(psi.E(X).real) - np.sin(2 * a)) < 1e-12
    C = to_np(psi.correlator(Z, Z, 5))
    np.testing.assert_allclose(C, 0.0, atol=1e-12)


def test_right_and_mixed_gauges_match_jax():
    A = _tensor(60, 2, 4)
    for t, j in zip(timps.right_orthogonalise(torch.from_numpy(A)), jimps.right_orthogonalise(jnp.asarray(A))):
        _close(t, j)
    AR = to_np(timps.right_orthogonalise(torch.from_numpy(A))[0])
    np.testing.assert_allclose(np.einsum("sij,skj->ik", AR, AR.conj()), np.eye(4), atol=1e-10)
    st, sj = _pair([A])
    AL, AR, C = (to_np(x) for x in st.mixed())
    for t, j in zip((AL, AR, C), sj.mixed()):
        _close(t, j)
    np.testing.assert_allclose(np.einsum("sij,jk->sik", AL, C), np.einsum("ij,sjk->sik", C, AR), atol=1e-10)


@pytest.mark.parametrize("n", [1, 3])
def test_right_canonicalise_matches_jax(n):
    """tests/test_imps.py:189-196: per-site right-canonical tensors, each
    JAX's (the same sign-fixed QR gauge)."""
    st, sj = _pair([_tensor(70 + k) for k in range(n)])
    ct, cj = st.right_canonicalise(), sj.right_canonicalise()
    assert len(ct) == n
    for k in range(n):
        _close(ct[k], cj[k])
        A = to_np(ct[k])
        np.testing.assert_allclose(np.einsum("sij,skj->ik", A, A.conj()), np.eye(2), atol=1e-10)


def test_schmidt_entropy_truncation_match_jax():
    """tests/test_correlations.py:337-387: Schmidt values (descending,
    normalised), entropy, and the truncation of a D = 4 state to D = 2
    and to itself (weight 1, unit overlap)."""
    st, sj = _pair([_tensor(80, 2, 4)])
    s = to_np(st.schmidt_values())
    _close(s, sj.schmidt_values())
    assert np.all(np.diff(s) <= 1e-12) and abs(np.sum(s ** 2) - 1) < 1e-10
    _close(st.entanglement_entropy(), sj.entanglement_entropy())
    for D_new in (2, 4):
        (tt, wt), (tj, wj) = st.truncated(D_new), sj.truncated(D_new)
        _close(tt[0], tj[0])
        _close(wt, wj)
    same, w = st.truncated(4)
    assert abs(float(w) - 1) < 1e-10 and abs(float(same.overlap(st)) - 1) < 1e-8
    prod = timps.iMPS([torch.eye(4, dtype=torch.complex128)[:, :2].reshape(2, 2, 2).transpose(0, 1)])
    assert float(prod.entanglement_entropy()) < 1e-10


def test_correlations_match_jax():
    """tests/test_correlations.py: the connected correlator, the
    correlation length (against numpy's spectrum too) and the static
    structure factor at a scalar and a vector of momenta."""
    A = _tensor(90, 2, 3)
    st, sj = _pair([A])
    _close(st.correlator(Z, X, 6), sj.correlator(Z.numpy(), X.numpy(), 6))
    _close(st.correlation_length(), sj.correlation_length(), atol=1e-8)
    AL = to_np(st.left_canonicalise()[0])
    E = np.einsum("sik,sjl->ijkl", AL, AL.conj()).reshape(9, 9)
    w = np.sort(np.abs(np.linalg.eigvals(E)))[::-1]
    assert abs(float(st.correlation_length()) + 1 / np.log(w[1] / w[0])) < 1e-5 * float(st.correlation_length())
    _close(st.static_structure_factor(Z, 0.7, 20), sj.static_structure_factor(Z.numpy(), 0.7, 20))
    p = np.array([0.0, 1.0, np.pi])
    _close(st.static_structure_factor(Z, torch.from_numpy(p), 20), sj.static_structure_factor(Z.numpy(), p, 20))


def test_correlation_length_complex_subdominant():
    """tests/test_correlations.py:390-414: against numpy's spectrum on six
    random D = 3 states, and the spectral radius of a matrix whose
    dominant pair is complex (0.8)."""
    from qmps_torch.core.linalg import spectral_radius_dense
    from qmps_tpu.mps.transfer import spectral_radius_dense as jrho

    for seed in range(6):
        st = timps.iMPS([torch.from_numpy(_tensor(100 + seed, 2, 3))])
        AL = to_np(st.left_canonicalise()[0])
        w = np.sort(np.abs(np.linalg.eigvals(np.einsum("sik,sjl->ijkl", AL, AL.conj()).reshape(9, 9))))[::-1]
        xi_true = -1.0 / np.log(w[1] / w[0])
        assert abs(float(st.correlation_length()) - xi_true) / xi_true < 1e-5
    th = 1.2
    M = np.zeros((4, 4), complex)
    M[:2, :2] = 0.8 * np.array([[np.cos(th), -np.sin(th)], [np.sin(th), np.cos(th)]])
    M[2, 2], M[3, 3] = 0.3, 0.1
    assert abs(float(spectral_radius_dense(torch.from_numpy(M))) - 0.8) < 1e-8
    _close(spectral_radius_dense(torch.from_numpy(M)), jrho(jnp.asarray(M)), atol=1e-12)


def test_map_and_transfer_matrix_match_jax():
    A, B = _tensor(110, 2, 3), _tensor(111, 2, 3)
    mt, mj = timps.Map(torch.from_numpy(A), torch.from_numpy(B)), jimps.Map(jnp.asarray(A), jnp.asarray(B))
    for t, j in zip(mt.left_fixed_point(), mj.left_fixed_point()):
        _close(t, j)
    lam, r = mt.right_fixed_point()
    _, l = mt.left_fixed_point()
    assert float(mt.is_right_eigenvector(r, lam)) < 1e-8 and float(mt.is_right_eigenvector(r)) < 1e-8
    assert float(mt.is_left_eigenvector(l)) < 1e-8
    _close(mt.is_right_eigenvector(r + 0.1), mj.is_right_eigenvector(jnp.asarray(to_np(r) + 0.1)))
    _close(mt.is_left_eigenvector(l + 0.1), mj.is_left_eigenvector(jnp.asarray(to_np(l) + 0.1)))
    for t, j in zip(timps.TransferMatrix(torch.from_numpy(A)).eigs(), jimps.TransferMatrix(jnp.asarray(A)).eigs()):
        _close(t, j)


def test_random_states():
    g = torch.Generator().manual_seed(3)
    psi = timps.iMPS.random(g, 2, 3, n=2, device="cpu")
    assert len(psi) == 2 and psi.D == 3 and psi[0].dtype == torch.complex128
    assert not torch.equal(psi[0], psi[1])
    assert timps.random_tensor(torch.Generator().manual_seed(3), 2, 3, device="cpu").equal(psi[0])
    psi32 = timps.iMPS.random(None, dtype=torch.complex64, device="cpu")
    assert psi32[0].dtype == torch.complex64
    can = psi.left_canonicalise()
    np.testing.assert_allclose(float(timps.iMPS([can.blocked]).overlap(timps.iMPS([psi.blocked]))), 1.0, atol=1e-8)
    assert jax.devices()[0].platform == "cpu"


def test_rank_deficient_float32_stays_finite():
    """tests/test_imps.py:233-253 (slow there, for its compile): a product
    state embedded at D = 4 in complex64: canonical forms, the mixed
    gauge, entropy and truncation stay finite (the jitter and the log's
    floor scale with the type)."""
    A4 = torch.zeros(2, 4, 4, dtype=torch.complex64)
    A4[0, 0, 0] = A4[1, 1, 0] = 1
    psi = timps.iMPS([A4])
    assert torch.isfinite(torch.view_as_real(psi.left_canonicalise()[0])).all()
    for x in psi.mixed():
        assert torch.isfinite(torch.view_as_real(x)).all()
    S = float(psi.entanglement_entropy())
    assert np.isfinite(S) and S < 1e-3
    state, w = psi.truncated(2)
    assert torch.isfinite(torch.view_as_real(state[0])).all() and float(w) > 0.999
