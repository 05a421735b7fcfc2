"""The environment unroll's two kernels, by their plain twins on the CPU
(``qmps_torch.kernels.stiefel_unroll``): the hand-derived reverse
recurrence against plain autograd through ``mps/transfer._power_forward``
and against conj(jax.grad) of the JAX package's unroll energy, gradcheck of
the autograd Function over the twins, and the dispatch, which leaves the
CPU on ``_power_forward``.  The kernels themselves run on the card:
tests/test_torch_cuda.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import to_np
from qmps_torch.ham.hamiltonian import tfim
from qmps_torch.kernels import stiefel_unroll as su
from qmps_torch.mps import transfer as ttr
from qmps_torch.optim import riemann as tri
from qmps_tpu.optim import riemann as jri

GRID = [(D, iters) for D in (2, 4, 8) for iters in (1, 24, 96)]


def _isometry(seed, D, rows=None):
    """A (rows, 2D, D) (or (2D, D)) complex128 isometry, rows (i, s)."""
    rng = np.random.default_rng(seed)
    shape = (2 * D, D) if rows is None else (rows, 2 * D, D)
    return np.linalg.qr(rng.normal(size=shape) + 1j * rng.normal(size=shape))[0]


def _cotangents(seed, rows, D):
    rng = np.random.default_rng(seed)
    c = lambda *s: torch.from_numpy(rng.normal(size=s) + 1j * rng.normal(size=s))  # noqa: E731
    return c(rows, D, D), c(rows)


@pytest.mark.parametrize("D, iters", GRID)
def test_twin_cotangent_equals_autograd_through_power_forward(D, iters):
    """A's cotangent of a loss in both outputs (r and lam), by the twins'
    reverse recurrence and by plain autograd through ``_power_forward``,
    at complex128 from a random (not hermitian) start: 1e-10; r and lam
    equal."""
    rows = 3
    V = torch.from_numpy(_isometry(D + iters, D, rows))
    A = tri._tensor(V, D)
    rng = np.random.default_rng(5)
    r0 = torch.from_numpy(rng.normal(size=(rows, D, D)) + 1j * rng.normal(size=(rows, D, D)))
    g_r, g_lam = _cotangents(7, rows, D)

    def loss(lam, r):
        return (g_r.conj() * r).real.sum() + (g_lam.conj() * lam).real.sum()

    grads = []
    for fn in (lambda A: su.unroll_eigpair(A, r0, iters), lambda A: ttr._power_forward(A, A, r0, iters)):
        Ag = A.detach().requires_grad_()
        lam, r = fn(Ag)
        grads.append((lam, r, torch.autograd.grad(loss(lam, r), Ag)[0]))
    (lam_t, r_t, g_t), (lam_a, r_a, g_a) = grads
    assert (r_t - r_a).abs().max() < 1e-12 and (lam_t - lam_a).abs().max() < 1e-12
    assert (g_t - g_a).abs().max() <= 1e-10 * g_a.abs().max()


@pytest.mark.parametrize("D, iters", GRID)
def test_gradcheck_of_the_function_over_the_twins(D, iters):
    """torch.autograd.gradcheck at complex128 of both outputs in A, the
    twins forward and backward (fast mode: one random direction)."""
    A = tri._tensor(torch.from_numpy(_isometry(11 + D, D, 2)), D).detach().requires_grad_()
    r0 = torch.eye(D, dtype=A.dtype) / D ** 0.5
    assert torch.autograd.gradcheck(lambda A: su.unroll_eigpair(A, r0, iters), (A,), fast_mode=True)


@pytest.mark.parametrize("D, iters", GRID)
def test_twin_gradient_matches_conj_jax_grad(D, iters):
    """The warm unroll energy's gradient in the isometry, through the twins,
    against conj(jax.grad) of ``qmps_tpu``'s ``isometry_energy_warm(...,
    "unroll")`` from the same V and r0: energy 1e-12, gradient 1e-10."""
    V = _isometry(3 * D + iters, D)
    h = tfim(0.7 + 0.01 * D).to_matrix()
    r0 = np.eye(D, dtype=complex) / np.sqrt(D)
    Vt = torch.from_numpy(V).requires_grad_()
    A = tri._tensor(Vt, D)
    _, r = su.unroll_eigpair(A, torch.from_numpy(r0), iters)
    e = tri._energy(A, r, torch.from_numpy(h))
    (g,) = torch.autograd.grad(e, Vt)
    e_j, g_j = jax.value_and_grad(lambda V: jri.isometry_energy_warm(V, jnp.asarray(h), D, jnp.asarray(r0), iters,
                                                                     "unroll")[0])(jnp.asarray(V))
    assert abs(e.item() - float(e_j)) < 1e-12
    np.testing.assert_allclose(to_np(g), np.conj(np.asarray(g_j)), atol=1e-10)


@pytest.mark.parametrize("batch", [(), (2, 3)], ids=["one_tensor", "two_batch_dims"])
def test_function_takes_any_batch_and_a_broadcast_start(batch):
    """A with no batch dimension or two, r0 one (D, D) matrix broadcast over
    them: r, lam and A's cotangent equal ``_power_forward``'s (1e-12)."""
    D, iters = 3, 24
    V = torch.from_numpy(_isometry(2, D, int(np.prod(batch, dtype=int)))).reshape(batch + (2 * D, D))
    A = tri._tensor(V, D)
    r0 = torch.eye(D, dtype=A.dtype) / D ** 0.5
    out = []
    for fn in (lambda A: su.unroll_eigpair(A, r0, iters), lambda A: ttr._power_forward(A, A, r0, iters)):
        Ag = A.detach().requires_grad_()
        lam, r = fn(Ag)
        out.append((lam, r, torch.autograd.grad(r.real.sum() + lam.imag.sum(), Ag)[0]))
    for x, y in zip(*out):
        assert x.shape == y.shape and (x - y).abs().max() < 1e-12


def test_without_gradient_the_forward_saves_nothing(monkeypatch):
    """Under no_grad, A requiring a gradient or not, the Function runs the
    forward alone: the twin is asked not to save, and the result carries
    no graph."""
    D = 4
    A = tri._tensor(torch.from_numpy(_isometry(1, D, 2)), D).requires_grad_()
    r0 = torch.eye(D, dtype=A.dtype) / D ** 0.5
    asked = []
    fwd = su._fwd_plain

    def spy(V, r0, iters, save):
        asked.append(save)
        return fwd(V, r0, iters, save)

    monkeypatch.setattr(su, "_fwd_plain", spy)
    with torch.no_grad():
        lam, r = su.unroll_eigpair(A, r0, 5)
    su.unroll_eigpair(A.detach(), r0, 5)
    su.unroll_eigpair(A, r0, 5)
    monkeypatch.undo()
    assert asked == [False, False, True]
    assert su._fwd_plain(A.detach().transpose(-3, -2), r0.expand(2, D, D), 5, False)[2:] == (None, None)
    assert lam.grad_fn is None and r.grad_fn is None
    lam_p, r_p = ttr._power_forward(A.detach(), A.detach(), r0, 5)
    assert (r - r_p).abs().max() < 1e-12 and (lam - lam_p).abs().max() < 1e-12


@pytest.mark.parametrize("dtype", [torch.complex64, torch.complex128])
def test_cpu_dispatch_is_plain_autograd_bit_for_bit(dtype):
    """On the CPU ``right_eigpair_warm_unroll`` is ``_power_forward``, bit for
    bit, value and gradient, and launches nothing."""
    from qmps_torch.kernels import _lib

    D = 4
    A0 = tri._tensor(torch.from_numpy(_isometry(9, D, 3)).to(dtype), D)
    r0 = torch.eye(D, dtype=dtype) / D ** 0.5
    _lib.reset_launches()
    out = []
    for fn in (ttr.right_eigpair_warm_unroll, ttr._power_forward):
        A = A0.detach().requires_grad_()
        lam, r = fn(A, A, r0, 24)
        out.append((lam, r, torch.autograd.grad(r.real.sum(), A)[0]))
    assert all(torch.equal(x, y) for x, y in zip(*out))
    assert not any(_lib.launches.values())
