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


def test_exact_oracles_are_the_same():
    """The copied XY, XXZ and Baxter oracles equal the JAX package's
    (1e-14), and reach their limits: delta -> 1 the Bethe value (1e-5),
    delta -> infinity the Ising one; delta <= 1 is refused."""
    from qmps_torch.ham import exact as texact
    from qmps_torch.ham.classical_baselines import heisenberg_exact_energy

    assert abs(texact.xy_gs_energy() - jexact.xy_gs_energy()) < 1e-14
    for delta in (1.0 + 1e-6, 1.5, 2.0, 50.0):
        assert abs(texact.xxz_gs_energy(delta) - jexact.xxz_gs_energy(delta)) < 1e-14 * max(1.0, delta)
        assert abs(texact.xxz_staggered_magnetization(delta) - jexact.xxz_staggered_magnetization(delta)) < 1e-14
    assert abs(texact.xxz_gs_energy(1.0 + 1e-6) - heisenberg_exact_energy()) < 1e-5
    assert abs(texact.xxz_gs_energy(50.0) + 50.0) < 0.1
    assert 0.999 < texact.xxz_staggered_magnetization(50.0) < 1.0
    for f in (texact.xxz_gs_energy, texact.xxz_staggered_magnetization):
        with pytest.raises(ValueError):
            f(0.5)


def test_classical_baselines_are_the_same():
    """The copied ED, iTEBD and Bethe baselines equal the JAX package's
    (1e-14) on small chains, and the generic ED reproduces the TFIM ED
    (1e-10)."""
    from qmps_torch.ham import classical_baselines as tcb
    from qmps_torch.ham.hamiltonian import heisenberg, tfim

    h = tfim(1.3).to_matrix()
    pairs = [
        (tcb.tfim_ed_energy(L=8, g=1.3), jcb.tfim_ed_energy(L=8, g=1.3)),
        (tcb.nnn_ising_ed_energy(L=8, g=0.5, J2=0.2), jcb.nnn_ising_ed_energy(L=8, g=0.5, J2=0.2)),
        (tcb.ed_gs_energy(heisenberg().to_matrix(), L=8), jcb.ed_gs_energy(heisenberg().to_matrix(), L=8)),
        (tcb.itebd_gs_energy(1.0, dts=(0.1,), sweeps_per_dt=50), jcb.itebd_gs_energy(1.0, dts=(0.1,),
                                                                                      sweeps_per_dt=50)),
        (tcb.heisenberg_exact_energy(2.0), jcb.heisenberg_exact_energy(2.0)),
    ]
    for got, want in pairs:
        assert abs(got - want) < 1e-14 * max(1.0, abs(want)), (got, want)
    assert abs(tcb.ed_gs_energy(h, L=10) - tcb.tfim_ed_energy(L=10, g=1.3)) < 1e-10
