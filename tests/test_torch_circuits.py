"""qmps_torch's gates, circuit compiler, full15 ansatz, unitary_to_tensor
and merge against qmps_tpu's, on the same seeded numpy inputs at
complex128 (1e-12)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import left_canonical, to_np
from qmps_torch.circuits import ansatze as tans
from qmps_torch.circuits import ir as tir
from qmps_torch.core import gates as tg
from qmps_torch.core import paulis as tp
from qmps_torch.embed.unitaries import unitary_to_tensor
from qmps_torch.mps.imps import merge
from qmps_tpu.circuits import ansatze as jans
from qmps_tpu.circuits import ir as jir
from qmps_tpu.core import gates as jg
from qmps_tpu.core import paulis as jp
from qmps_tpu.embed import unitaries as jemb
from qmps_tpu.mps import imps as jimps


def _params(B=6, seed=0):
    return np.random.default_rng(seed).uniform(-np.pi, np.pi, (B, 15))


@pytest.mark.parametrize("name", ["rx", "ry", "rz"])
def test_rotations_match_jax(name):
    t = np.random.default_rng(1).uniform(-4, 4, (3, 5))
    got = to_np(getattr(tg, name)(torch.from_numpy(t)))
    want = np.asarray(jax.vmap(jax.vmap(getattr(jg, name)))(jnp.asarray(t)))
    assert got.shape == (3, 5, 2, 2)
    np.testing.assert_allclose(got, want, atol=1e-12)
    # the batched builder: one rotation per last index, axes by name
    axes = "xyzzy"
    many = to_np(tg.rotations(torch.from_numpy(t), axes))
    for k, a in enumerate(axes):
        np.testing.assert_allclose(many[:, k], to_np(getattr(tg, "r" + a)(torch.from_numpy(t[:, k]))), atol=1e-15)


def test_float32_angles_give_complex64_gates():
    assert tg.rz(torch.zeros(3, dtype=torch.float32)).dtype == torch.complex64
    assert tans.shallow_full_state(torch.zeros(2, 15, dtype=torch.float32)).dtype == torch.complex64


def test_constants_match_jax():
    for name in ("H", "S", "S_DAG", "T", "CNOT", "CZ", "SWAP"):
        np.testing.assert_allclose(to_np(getattr(tg, name)), np.asarray(getattr(jg, name)), atol=1e-15)
    for c in "IXYZ":
        np.testing.assert_array_equal(to_np(tp.PAULI[c]), np.asarray(jp.PAULI[c]))
    ops = [tp.X, tp.Y, tp.Z]
    np.testing.assert_allclose(to_np(tp.kron_all(ops)), np.asarray(jp.kron_all([jp.X, jp.Y, jp.Z])), atol=0)


def test_full15_unitary_matches_jax():
    """The ops list through circuit_unitary and the compiled product of
    4x4 factors, both against JAX's shallow_full_state, for a (6, 15)
    batch; the result is unitary."""
    p = _params()
    want = np.asarray(jax.vmap(jans.shallow_full_state)(jnp.asarray(p)))
    pt = torch.from_numpy(p)
    ops, n = tans.shallow_full_state_ops(pt)
    via_ops = to_np(tir.circuit_unitary(ops, n))
    compiled = to_np(tans.shallow_full_state(pt))
    np.testing.assert_allclose(via_ops, want, atol=1e-12)
    np.testing.assert_allclose(compiled, want, atol=1e-12)
    np.testing.assert_allclose(compiled @ compiled.conj().swapaxes(-1, -2),
                               np.broadcast_to(np.eye(4), (6, 4, 4)), atol=1e-12)


def test_circuit_state_and_dagger_on_three_qubits():
    """Non-adjacent and reversed wires, a batched gate among fixed ones,
    and the inverse circuit, against JAX's circuit_state per element."""
    th = np.array([0.3, -1.2])
    p = _params(1, seed=2)[0]
    ops_t = [(tg.H, (0,)), (tg.CNOT, (2, 0)), (tg.ry(torch.from_numpy(th)), (1,)),
             (tans.shallow_full_state(torch.from_numpy(p)), (2, 1)), (tg.CZ, (0, 2))]
    psi_t = to_np(tir.circuit_state(ops_t, 3, dtype=torch.complex128))
    back = to_np(tir.circuit_state(tir.dagger_ops(ops_t), 3, psi0=torch.from_numpy(psi_t)))
    for b in range(2):
        ops_j = [(jg.H, (0,)), (jg.CNOT, (2, 0)), (jg.ry(th[b]), (1,)),
                 (jans.shallow_full_state(jnp.asarray(p)), (2, 1)), (jg.CZ, (0, 2))]
        np.testing.assert_allclose(psi_t[b], np.asarray(jir.circuit_state(ops_j, 3)), atol=1e-12)
        np.testing.assert_allclose(back[b], np.eye(8)[0], atol=1e-12)


def test_unitary_to_tensor_and_merge_match_jax():
    U = np.asarray(jax.vmap(jans.shallow_full_state)(jnp.asarray(_params(4, seed=3))))
    A_j = np.asarray(jax.vmap(jemb.unitary_to_tensor)(jnp.asarray(U)))
    A_t = to_np(unitary_to_tensor(torch.tensor(U)))
    np.testing.assert_allclose(A_t, A_j, atol=1e-12)
    B = left_canonical(np.random.default_rng(4), 4)
    want = np.asarray(jax.vmap(jimps.merge)(jnp.asarray(A_j), jnp.asarray(B)))
    np.testing.assert_allclose(to_np(merge(torch.tensor(A_j), torch.from_numpy(B))), want, atol=1e-12)
