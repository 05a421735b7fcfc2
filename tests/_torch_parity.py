"""Shared helpers of the qmps_torch parity tests (not collected: no test_
prefix).  Each test feeds the same numpy inputs, made from a seed, to a
JAX function of qmps_tpu and to its qmps_torch port, and compares values
and gradients.  For a real loss of complex inputs torch's ``.grad`` is
``conj(jax.grad)``; :func:`assert_parity` compares them with that
correction.
"""
import numpy as np
import pytest
import torch

# the suite runs under several xdist workers on a few cores
torch.set_num_threads(1)

_X = np.array([[0.0, 1.0], [1.0, 0.0]])
_Z = np.diag([1.0, -1.0])
_I = np.eye(2)


def require_cuda() -> torch.device:
    """The CUDA device, or skip the calling test (decided when the test
    runs, never at import)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run with -m cuda on the card)")
    return torch.device("cuda")


def left_canonical(rng, B, D=2):
    """(B, 2, D, D) complex128 left-canonical tensors A[s, i, j] from numpy
    QR of complex normals (at D = 2 the sweep's own initial layout)."""
    x = rng.standard_normal((B, 2 * D, D)) + 1j * rng.standard_normal((B, 2 * D, D))
    V, _ = np.linalg.qr(x)
    return V.reshape(B, D, 2, D).transpose(0, 2, 1, 3).copy()


def nearest_isometry(A):
    """The nearest left-canonical tensors (B, 2, D, D) to each A, by SVD."""
    B, _, D, _ = A.shape
    x = A.transpose(0, 2, 1, 3).reshape(B, 2 * D, D)
    U, _, Vh = np.linalg.svd(x, full_matrices=False)
    return (U @ Vh).reshape(B, D, 2, D).transpose(0, 2, 1, 3).copy()


def tfim_h(g):
    """Host TFIM two-site matrices -ZZ + g (XI + IX)/2 for each g (n, 4, 4)."""
    g = np.asarray(g, np.float64)[..., None, None]
    return -np.kron(_Z, _Z) + g / 2 * (np.kron(_X, _I) + np.kron(_I, _X))


def transfer_matrices(B, seed):
    """One-site transfer matrices (B, 4, 4) of left-canonical D = 2 tensors
    (dominant eigenvalue 1)."""
    A = left_canonical(np.random.default_rng(seed), B)
    return np.einsum("bsik,bsjl->bijkl", A, A.conj()).reshape(B, 4, 4)


def phase_aligned(v, ref):
    """Rows of v rotated by the global phase that best matches ref."""
    ph = np.sum(v.conj() * ref, axis=-1)
    return v * (ph / np.abs(ph))[:, None]


def to_np(t) -> np.ndarray:
    return t.detach().cpu().resolve_conj().numpy()


def assert_parity(jax_fn, torch_fn, args, atol, grad_atol=None):
    """Run ``jax_fn`` and ``torch_fn`` on the same numpy ``args`` and
    compare their outputs to ``atol``; with ``grad_atol``, also the
    gradients of the summed output with respect to every argument, torch's
    against conj(jax.grad)."""
    # imported here: the card's tests (test_torch_cuda.py) use this module
    # on a machine without JAX
    import jax
    import jax.numpy as jnp

    jargs = [jnp.asarray(a) for a in args]
    targs = [torch.tensor(a, requires_grad=grad_atol is not None) for a in args]
    out_j = np.asarray(jax_fn(*jargs))
    out_t = torch_fn(*targs)
    np.testing.assert_allclose(to_np(out_t), out_j, atol=atol)
    if grad_atol is None:
        return
    out_t.sum().backward()
    for k, (a, t) in enumerate(zip(args, targs)):
        gj = jax.grad(lambda x: jnp.sum(jax_fn(*jargs[:k], x, *jargs[k + 1:])))(jargs[k])
        np.testing.assert_allclose(to_np(t.grad), np.conj(np.asarray(gj)), atol=grad_atol)


def assert_brick_params_match(got, want):
    """Deep brick-wall parameters (..., n_bricks * 19) to 1e-8, but on the
    coordinates whose gradient is zero, which adam moves by rounding alone
    (the two packages' values differ there by ~1e-8): each U2f's phase a
    (every brick's parameters 0, 4, 8 and 12) and parameter 3 (the first
    brick's u1 phase d: wire 0 enters in |0>), held within 1e-7."""
    got, want = to_np(got), np.asarray(want)
    n = got.shape[-1]
    gauge = np.zeros(n, bool)
    gauge[[b + j for b in range(0, n, 19) for j in (0, 4, 8, 12)] + [3]] = True
    np.testing.assert_allclose(got[..., ~gauge], want[..., ~gauge], atol=1e-8)
    np.testing.assert_allclose(got[..., gauge], want[..., gauge], atol=1e-7)


_VIEWS = {"view", "_unsafe_view", "expand", "reshape", "transpose", "t", "permute", "select", "slice",
          "unsqueeze", "squeeze", "as_strided", "alias", "detach", "_reshape_alias", "conj", "resolve_conj",
          "_conj", "real", "imag", "view_as_real", "view_as_complex", "split", "unbind", "diagonal", "_neg_view",
          "lift_fresh", "unflatten", "chunk"}


def dispatched(fn) -> int:
    """Operations ``fn`` dispatches, views not counted, on its second call
    (first-call set-up not counted): on the card, each is roughly one
    launch, and the drivers are bound by the host's dispatch (PERF.md §5)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func.__name__.split(".")[0] not in _VIEWS:
                Count.n += 1
            return func(*args, **(kwargs or {}))

    fn()
    with Count():
        fn()
    return Count.n
