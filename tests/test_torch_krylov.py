"""qmps_torch.core.krylov and the matvec fixed points of
qmps_torch.mps.transfer against qmps_tpu's, at complex128 on the CPU.
Mirrors tests/test_krylov.py, with its sizes and tolerances; the same
numpy inputs go through both packages.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import to_np
from qmps_torch.core import krylov as tk
from qmps_torch.mps import transfer as ttr
from qmps_tpu.core import krylov as jk
from qmps_tpu.mps import transfer as jtr
from qmps_tpu.mps.imps import iMPS as JiMPS


def _random_matrix_with_gap(rng, n, gap_ratio):
    """Dense matrix with |lam_2| / |lam_1| = gap_ratio, random eigenbasis."""
    evals = np.concatenate([[1.0, gap_ratio], rng.uniform(0.1, 0.9 * gap_ratio, n - 2)]).astype(np.complex128)
    Q = np.linalg.qr(rng.normal(size=(n, n)) + 1j * rng.normal(size=(n, n)))[0]
    return Q @ np.diag(evals) @ Q.conj().T, Q[:, 0]


def _mv(M):
    M = torch.from_numpy(M)
    return lambda x: (M @ x[..., None])[..., 0]


def test_arnoldi_factorization(rng):
    """A Q_k^T = Q_{k+1}^T H with an orthonormal basis (1e-10), and Q, H
    equal to JAX's (1e-12)."""
    n, k = 40, 12
    M = rng.normal(size=(n, n)) + 1j * rng.normal(size=(n, n))
    v0 = rng.normal(size=(n,)) + 0j
    Q, H = (to_np(x) for x in tk.arnoldi(_mv(M), torch.from_numpy(v0), k))
    assert np.linalg.norm(M @ Q[:k].T - Q.T @ H) < 1e-10
    assert np.linalg.norm(Q.conj() @ Q.T - np.eye(k + 1)) < 1e-10
    Qj, Hj = jk.arnoldi(lambda x: jnp.asarray(M) @ x, jnp.asarray(v0), k)
    np.testing.assert_allclose(Q, np.asarray(Qj), atol=1e-12)
    np.testing.assert_allclose(H, np.asarray(Hj), atol=1e-12)


@pytest.mark.parametrize(
    "gap_ratio",
    [0.5, pytest.param(0.99, marks=pytest.mark.slow), pytest.param(0.999, marks=pytest.mark.slow)],
)
def test_arnoldi_near_degenerate(rng, gap_ratio):
    """Gap ratio up to 0.999 at n = 1024 (D = 32), 0.5 at n = 256 in the
    fast suite: lam within 1e-9 of 1, residual < 1e-8, overlap with the
    true vector > 1 - 1e-8; lam equal to JAX's to 1e-12."""
    n, k, restarts = (1024, 48, 4) if gap_ratio > 0.9 else (256, 24, 2)
    M, v_true = _random_matrix_with_gap(rng, n, gap_ratio)
    v0 = rng.normal(size=(n,)) + 0j
    lam, v = tk.dominant_eigpair_arnoldi(_mv(M), torch.from_numpy(v0), k=k, restarts=restarts)
    lam, v = complex(lam), to_np(v)
    assert abs(lam - 1.0) < 1e-9
    assert np.linalg.norm(M @ v - lam * v) < 1e-8
    assert abs(np.vdot(v, v_true)) > 1 - 1e-8
    if gap_ratio < 0.9:
        Mj = jnp.asarray(M)
        lam_j, _ = jk.dominant_eigpair_arnoldi(lambda x: Mj @ x, jnp.asarray(v0), k=k, restarts=restarts)
        assert abs(lam - complex(lam_j)) < 1e-12


def test_gmres_solve_exact_at_full_k(rng):
    """k = n makes GMRES a direct solver regardless of spectrum (1e-10),
    and x equals JAX's (1e-10)."""
    n = 60
    M = rng.normal(size=(n, n)) + 1j * rng.normal(size=(n, n)) + 4.0 * np.eye(n)
    b = rng.normal(size=(n,)) + 1j * rng.normal(size=(n,))
    x, res = tk.gmres_solve(_mv(M), torch.from_numpy(b), k=n, restarts=1)
    assert float(res) < 1e-10
    assert np.linalg.norm(M @ to_np(x) - b) < 1e-10
    xj, _ = jk.gmres_solve(lambda v: jnp.asarray(M) @ v, jnp.asarray(b), k=n, restarts=1)
    np.testing.assert_allclose(to_np(x), np.asarray(xj), atol=1e-10)


def test_gmres_solve_restarted(rng):
    """Restarted GMRES(k << n) converges when the field of values excludes
    the origin (the bordered systems' shape): residual < 1e-10, x equal
    to JAX's (1e-10)."""
    n = 200
    M = rng.normal(size=(n, n)) + 1j * rng.normal(size=(n, n)) + 20.0 * np.eye(n)
    b = rng.normal(size=(n,)) + 1j * rng.normal(size=(n,))
    x, _ = tk.gmres_solve(_mv(M), torch.from_numpy(b), k=40, restarts=10)
    assert np.linalg.norm(M @ to_np(x) - b) < 1e-10
    xj, _ = jk.gmres_solve(lambda v: jnp.asarray(M) @ v, jnp.asarray(b), k=40, restarts=10)
    np.testing.assert_allclose(to_np(x), np.asarray(xj), atol=1e-10)


def test_gmres_rank_loss_gives_the_least_squares_solution(rng):
    """A Hessenberg matrix that loses rank: a zero right-hand side (H = 0)
    leaves x = 0, and a matvec with a 3-dimensional range breaks Arnoldi
    down at step 3 of 8; both finite, the second solved to 1e-10 as JAX's
    SVD lstsq solves it."""
    n = 12
    x, res = tk.gmres_solve(_mv(np.eye(n) + 0j), torch.zeros(n, dtype=torch.complex128), k=5, restarts=2)
    assert torch.equal(x, torch.zeros_like(x)) and float(res) == 0.0
    P = np.linalg.qr(rng.normal(size=(n, 3)) + 1j * rng.normal(size=(n, 3)))[0]
    M = P @ np.diag([2.0, 3.0, 5.0]) @ P.conj().T
    b = P @ (rng.normal(size=3) + 0j)
    x, _ = tk.gmres_solve(_mv(M), torch.from_numpy(b), k=8, restarts=1)
    assert np.all(np.isfinite(to_np(x))) and np.linalg.norm(M @ to_np(x) - b) < 1e-10
    xj, _ = jk.gmres_solve(lambda v: jnp.asarray(M) @ v, jnp.asarray(b), k=8, restarts=1)
    np.testing.assert_allclose(to_np(x), np.asarray(xj), atol=1e-10)


def test_batched_krylov_equals_per_element(rng):
    """A leading batch of 3 gives each element's unbatched Arnoldi,
    eigenpair (v up to its phase) and GMRES solution (1e-12)."""
    n = 30
    Ms = [rng.normal(size=(n, n)) + 1j * rng.normal(size=(n, n)) + 12.0 * np.eye(n) for _ in range(3)]
    Mb = torch.from_numpy(np.stack(Ms))
    v0 = torch.from_numpy(rng.normal(size=(3, n)) + 1j * rng.normal(size=(3, n)))

    def mvb(x):
        return (Mb @ x[..., None])[..., 0]

    Qb, Hb = tk.arnoldi(mvb, v0, 10)
    lam_b, v_b = tk.dominant_eigpair_arnoldi(mvb, v0, k=20, restarts=3)
    x_b, res_b = tk.gmres_solve(mvb, v0, k=15, restarts=4)
    assert x_b.shape == (3, n) and res_b.shape == (3,)
    for i, M in enumerate(Ms):
        Q, H = tk.arnoldi(_mv(M), v0[i], 10)
        torch.testing.assert_close(Qb[i], Q, atol=1e-12, rtol=0)
        torch.testing.assert_close(Hb[i], H, atol=1e-12, rtol=0)
        lam, v = tk.dominant_eigpair_arnoldi(_mv(M), v0[i], k=20, restarts=3)
        torch.testing.assert_close(lam_b[i], lam, atol=1e-12, rtol=0)
        # v's phase is that of lam^(2^50) in the Ritz squaring: rounding
        ph = torch.vdot(v, v_b[i])
        torch.testing.assert_close(v_b[i], v * ph / ph.abs(), atol=1e-12, rtol=0)
        x, _ = tk.gmres_solve(_mv(M), v0[i], k=15, restarts=4)
        torch.testing.assert_close(x_b[i], x, atol=1e-12, rtol=0)


def _jax_tensor(key, D):
    return np.asarray(JiMPS.random(key, 2, D)[0])


def test_matvec_fixed_point_matches_dense(key):
    """right_fixed_point(dense=False) agrees with the dense solver at D = 8
    (lam 1e-9, r 1e-8), and with JAX's matvec path (1e-9); the left fixed
    point alike."""
    A = _jax_tensor(key, 8)
    At = torch.from_numpy(A)
    lam_d, r_d = ttr.right_fixed_point(At, At, dense=True)
    lam_m, r_m = ttr.right_fixed_point(At, At, dense=False, iters=200)
    assert abs(complex(lam_d) - complex(lam_m)) < 1e-9
    assert np.linalg.norm(to_np(r_d) - to_np(r_m)) < 1e-8
    lam_j, r_j = jtr.right_fixed_point(jnp.asarray(A), jnp.asarray(A), dense=False, iters=200)
    assert abs(complex(lam_m) - complex(lam_j)) < 1e-9
    np.testing.assert_allclose(to_np(r_m), np.asarray(r_j), atol=1e-9)
    l_d = ttr.left_fixed_point(At, At, dense=True)[1]
    lam_l, l_m = ttr.left_fixed_point(At, At, dense=False)
    assert np.linalg.norm(to_np(l_d) - to_np(l_m)) < 1e-8
    lam_lj, l_j = jtr.left_fixed_point(jnp.asarray(A), jnp.asarray(A), dense=False)
    assert abs(complex(lam_l) - complex(lam_lj)) < 1e-9
    np.testing.assert_allclose(to_np(l_m), np.asarray(l_j), atol=1e-9)


def _fp_loss(tr, lib, dense):
    def loss(A):
        lam, r = tr.right_fixed_point(A, A, dense=dense, iters=200)
        return lib.abs(lam) + lib.abs(lib.trace(r))
    return loss


def test_matvec_gradients_match_dense_and_jax(key):
    """The bordered-GMRES adjoint of the matvec path gives the dense
    path's gradient (1e-7) and conj(jax.grad) of JAX's matvec path
    (1e-7) of |lam| + |tr r| at D = 4."""
    A = _jax_tensor(key, 4)
    grads = {}
    for dense in (True, False):
        At = torch.from_numpy(A).requires_grad_()
        _fp_loss(ttr, torch, dense)(At).backward()
        grads[dense] = to_np(At.grad)
    assert np.linalg.norm(grads[True] - grads[False]) < 1e-7
    g_j = jax.grad(_fp_loss(jtr, jnp, False))(jnp.asarray(A))
    np.testing.assert_allclose(grads[False], np.conj(np.asarray(g_j)), atol=1e-7)


def test_matvec_adjoint_gradcheck():
    """torch.autograd.gradcheck of the matvec pair (lam, v) in its
    holomorphic c-gauge, in A and B separately, at D = 2 and 3
    (complex128)."""
    rng = np.random.default_rng(5)
    D1, D2 = 2, 3
    A = torch.from_numpy(rng.normal(size=(2, D1, D1)) + 1j * rng.normal(size=(2, D1, D1))).requires_grad_()
    B = torch.from_numpy(rng.normal(size=(2, D2, D2)) + 1j * rng.normal(size=(2, D2, D2))).requires_grad_()
    # Arnoldi with k = n is exact: a budget of 20 matvecs converges the forward
    assert torch.autograd.gradcheck(lambda A, B: ttr._RightEigpairMatvec.apply(A, B, 20), (A, B), fast_mode=True)


def test_matvec_grad_in_a_descent_loop(key):
    """A value-and-gradient consumer in a loop (the shape that crashed the
    old GMRES adjoint on the TPU under lax.scan): three steps, finite."""
    A = torch.from_numpy(_jax_tensor(key, 4))
    vals = []
    for _ in range(3):
        Ag = A.detach().requires_grad_()
        lam, _ = ttr.right_fixed_point(Ag, Ag, dense=False, iters=96)
        (g,) = torch.autograd.grad(lam.abs(), Ag)
        A = A - 0.01 * g
        vals.append(lam.abs().item())
    assert np.all(np.isfinite(vals))
