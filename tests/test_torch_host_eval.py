"""qmps_torch.utils.host_eval (the host float64 readout, a copy of the JAX
package's numpy/scipy core) against qmps_tpu on tests/test_host_eval.py's
inputs, to 1e-12, and the one place where the port differs: a non-finite
``f32_ref`` is no reference, where the JAX package returns NaN."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qmps_torch.utils import host_eval as th
from qmps_tpu.mps.imps import iMPS, left_orthogonalise
from qmps_tpu.mps import transfer as jtr
from qmps_tpu.utils import host_eval as jh


def _left_canonical(key, D):
    return np.array(left_orthogonalise(iMPS.random(key, 2, D)[0])[0])


def _sweep_inputs(key, n, D, warm):
    """tests/test_host_eval.py's batches, rounded to complex64 (the JAX
    package reads device tensors through float32 planes, the port in
    their own type, so both then see the same numbers)."""
    As, rs = [], []
    for i, k in enumerate(jax.random.split(key, n)):
        A = _left_canonical(k, D)
        if warm:
            _, r = jtr.right_fixed_point(jnp.asarray(A), jnp.asarray(A))
            r = np.asarray((r + r.conj().T) / 2)
            r = r / np.linalg.norm(r)
        else:
            m = np.asarray(jax.random.normal(jax.random.fold_in(k, 7 if n == 3 else 3), (D, D))).astype(complex)
            r = (m + m.T) / 2
        As.append(A)
        rs.append(r)
    return np.stack(As).astype(np.complex64), np.stack(rs).astype(np.complex64)


@pytest.mark.parametrize("case", ["warm", "cold", "krylov_tail"])
def test_sweep_energies_match_jax(key, case):
    """The three readout paths of tests/test_host_eval.py:37-105 (warm
    power iteration, the masked adaptive loop from a cold start, the
    ARPACK tail): energies and eigenvalues to 1e-12."""
    n, D, g, kw = {"warm": (3, 6, [0.4, 1.0, 1.6], {}), "cold": (3, 5, [0.9, 1.0, 1.1], {}),
                   "krylov_tail": (2, 5, [0.8, 1.2], dict(power_iters=2, max_iters=4))}[case]
    As, rs = _sweep_inputs(key, n, D, warm=case == "warm")
    h = th.tfim_h64_batch(np.array(g))
    np.testing.assert_array_equal(h, jh.tfim_h64_batch(np.array(g)))
    e_t, lam_t = th.host_f64_sweep_energies(torch.from_numpy(As), torch.from_numpy(rs), h, **kw)
    e_j, lam_j = jh.host_f64_sweep_energies(jnp.asarray(As), jnp.asarray(rs), h, **kw)
    np.testing.assert_allclose(e_t, e_j, rtol=0, atol=1e-12)
    np.testing.assert_allclose(lam_t, lam_j, rtol=0, atol=1e-12)
    np.testing.assert_array_equal(th.device_to_host_c128(torch.from_numpy(As)),
                                  jh.device_to_host_c128(jnp.asarray(As)))


def test_gauge_free_energy_matches_jax(key):
    """tests/test_host_eval.py:108-133: a non-canonical D = 6 tensor, with
    no reference, a consistent one and an inconsistent one (NaN in both)."""
    A = np.asarray(iMPS.random(key, 2, 6)[0])
    A = (A / np.sqrt(np.sum(np.abs(A) ** 2))).astype(np.complex64)
    h = th.tfim_h64_batch(np.array([1.0]))[0]
    e = th.host_energy_gauge_free(torch.from_numpy(A), h)
    assert abs(e - jh.host_energy_gauge_free(jnp.asarray(A), h)) < 1e-12
    assert abs(th.host_energy_gauge_free(torch.from_numpy(A), h, f32_ref=e + 1e-4) - e) < 1e-12
    assert np.isnan(th.host_energy_gauge_free(torch.from_numpy(A), h, f32_ref=e + 1.0))
    assert np.isnan(jh.host_energy_gauge_free(jnp.asarray(A), h, f32_ref=e + 1.0))


@pytest.mark.parametrize("bad", [float("nan"), float("inf")])
def test_non_finite_reference_is_no_reference(key, bad):
    """The known difference, pinned: with a NaN or infinite f32_ref the JAX
    package throws the valid float64 readout away and returns NaN; the port
    returns the readout, equal to the one without a reference."""
    A = np.asarray(iMPS.random(key, 2, 4)[0])
    A = (A / np.sqrt(np.sum(np.abs(A) ** 2))).astype(np.complex64)
    h = th.tfim_h64_batch(np.array([0.7]))[0]
    e = th.host_energy_gauge_free(torch.from_numpy(A), h)
    assert np.isfinite(e)
    assert th.host_energy_gauge_free(torch.from_numpy(A), h, f32_ref=bad) == e
    assert th.host_energy_gauge_free(torch.from_numpy(A), h, f32_ref=torch.tensor(bad)) == e
    assert np.isnan(jh.host_energy_gauge_free(jnp.asarray(A), h, f32_ref=bad))
