"""qmps_torch.core.lie, the "su4"/"suN" ansatze and find_ground_state with
them, against qmps_tpu at complex128: the generator tables exactly, the
exponential maps (batched) to 1e-12, the energy at the same parameters to
1e-10 and the converged energy against the exact one."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import to_np
from qmps_torch.algorithms.ground_state import find_ground_state
from qmps_torch.circuits import ansatze as tans
from qmps_torch.core import lie as tlie
from qmps_torch.ham.exact import tfim_gs_energy_f64
from qmps_torch.ham.hamiltonian import tfim
from qmps_torch.objectives.energy import energy_exact_env
from qmps_tpu.circuits import ansatze as jans
from qmps_tpu.core import lie as jlie
from qmps_tpu.objectives import energy as jenergy


@pytest.mark.parametrize("N", [2, 3, 4, 8])
def test_su_generators_match_jax(N):
    np.testing.assert_array_equal(tlie.su_generators(N), jlie.su_generators(N))
    np.testing.assert_array_equal(tlie._first_column_generators(), jlie._first_column_generators())


@pytest.mark.parametrize("name,k,N", [("SU", 8, 3), ("U4", 15, 4), ("first_column_unitary", 7, 4)])
def test_exponential_maps_match_jax(name, k, N):
    """A (2, 3) batch of parameter vectors through the port at once, each
    through the JAX function alone: 1e-12; the results are unitary."""
    v = np.random.default_rng(k).standard_normal((2, 3, k))
    args = (N,) if name == "SU" else ()
    U_t = to_np(getattr(tlie, name)(torch.from_numpy(v), *args))
    U_j = np.stack([np.asarray(getattr(jlie, name)(jnp.asarray(x), *args)) for x in v.reshape(-1, k)])
    np.testing.assert_allclose(U_t, U_j.reshape(2, 3, N, N), atol=1e-12)
    np.testing.assert_allclose(U_t @ np.conj(np.swapaxes(U_t, -1, -2)),
                               np.broadcast_to(np.eye(N), U_t.shape), atol=1e-12)


@pytest.mark.parametrize("ansatz,D", [("su4", 2), ("suN", 2), ("suN", 4)])
def test_state_ansatz_energy_matches_jax(ansatz, D):
    """The state unitary and its exact-environment energy of tfim(1.2) at
    the same parameters: 1e-12 and 1e-10."""
    n = (2 * D) ** 2 - 1
    p = np.random.default_rng(D).standard_normal(n) * 0.5
    if ansatz == "su4":
        U_t, U_j = tans.full_state_su4(torch.from_numpy(p)), jans.full_state_su4(jnp.asarray(p))
    else:
        U_t, U_j = tans.full_state_suN(torch.from_numpy(p), D), jans.full_state_suN(jnp.asarray(p), D)
    np.testing.assert_allclose(to_np(U_t), np.asarray(U_j), atol=1e-12)
    h = tfim(1.2).to_matrix()
    e_t = float(energy_exact_env(U_t, h))
    e_j = float(jenergy.energy_exact_env(U_j, jnp.asarray(h)))
    assert abs(e_t - e_j) < 1e-10, (e_t, e_j)


@pytest.mark.parametrize("ansatz", ["suN", "su4"])
def test_find_ground_state_lie_ansatze_converge(ansatz):
    """find_ground_state's default "suN" and "su4" at D = 2 (300 L-BFGS
    steps, float64 on the CPU): the energy of the returned parameters,
    re-evaluated, equals the reported one to 1e-10 and lies at or above the
    exact energy of tfim(1.5), within 5e-4."""
    kw = {} if ansatz == "suN" else {"ansatz": ansatz}
    gs = find_ground_state(tfim(1.5), D=2, steps=300, device="cpu", **kw)
    assert gs.params.shape == (15,) and gs.U.shape == (4, 4) and gs.params.dtype == torch.float64
    e = float(energy_exact_env(tans.full_state_suN(gs.params, 2), tfim(1.5).to_matrix()))
    assert abs(e - gs.energy) < 1e-10
    err = gs.energy - float(tfim_gs_energy_f64(1.5))
    assert -1e-9 < err < 5e-4, err


def test_float32_parameters_exponentiate_in_complex128():
    """U4 of float32 parameters (1,000 vectors at each of four scales, up
    to generator entries of tens) equals the complex128 exponential of the
    same parameters rounded to complex64 (2e-7).  Prints, for the record
    (run with -s), what torch's complex64 matrix_exp, which core/lie
    avoids, loses on the same generators."""
    gen = torch.Generator().manual_seed(0)
    G = torch.from_numpy(tlie.su_generators(4)).to(torch.complex64)
    for scale in (0.5, 2.0, 5.0, 20.0):
        v = (torch.randn(1000, 15, generator=gen, dtype=torch.float64) * scale).float()
        U32, U64 = tlie.U4(v), tlie.U4(v.double())
        assert U32.dtype == torch.complex64
        err = (U32.to(torch.complex128) - U64).abs().max().item()
        H = torch.einsum("bk,kij->bij", v.to(torch.complex64), G)
        raw = (torch.linalg.matrix_exp(-1j * H).to(torch.complex128) - U64).abs().max().item()
        print(f"scale {scale}: max |H| {H.abs().max().item():.3g}, core/lie float32 {err:.3g}, "
              f"complex64 matrix_exp {raw:.3g}")
        assert err < 2e-7, (scale, err)
