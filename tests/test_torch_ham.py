"""The port's host float64 oracles and state conversion against the JAX
package: tfim_gs_energy_f64 and host_energy_d2 are copies and must agree
exactly; from_numpy carries arrays across with their values."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import left_canonical, tfim_h
from qmps_torch.ham.classical_baselines import host_energy_d2
from qmps_torch.ham.exact import tfim_gs_energy_f64
from qmps_torch.utils.convert import from_numpy
from qmps_tpu.ham import classical_baselines as jcb
from qmps_tpu.ham import exact as jexact


def test_tfim_gs_energy_f64_is_the_same_oracle():
    g = np.linspace(0.1, 2.0, 17)
    np.testing.assert_array_equal(tfim_gs_energy_f64(g), jexact.tfim_gs_energy_f64(g))
    # the closed form at g = 0 (classical Ising): -1 per site
    np.testing.assert_allclose(tfim_gs_energy_f64(0.0), -1.0, atol=1e-13)


def test_host_energy_d2_is_the_same_readout():
    A = left_canonical(np.random.default_rng(4), 3)
    h = tfim_h([0.4, 1.0, 1.6])
    for b in range(3):
        assert host_energy_d2(A[b], h[b]) == jcb.host_energy_d2(A[b], h[b])


@pytest.mark.parametrize("dtype", [None, torch.complex64])
def test_from_numpy_carries_jax_arrays(dtype):
    x = np.random.default_rng(5).standard_normal((3, 4, 2)) * (1 + 1j)
    t = from_numpy(jnp.asarray(x), dtype=dtype)
    assert t.device.type == "cpu" and t.dtype == (dtype or torch.complex128)
    np.testing.assert_allclose(t.numpy(), x, rtol=1e-7 if dtype else 0)
