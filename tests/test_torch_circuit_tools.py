"""qmps_torch's circuit tools held to qmps_tpu's at complex128 on the CPU:
the random-circuit factories and the OpenQASM exporter (numpy copies: the
same op lists and the same text), the QASM round trip through the port's
own circuit compiler (1e-10 up to the returned global phase), the
hardware-native gates and the finite-depth states (1e-12), and the
gradients of the parametrised gates (against conj(jax.grad))."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_parity  # noqa: F401  (one torch thread per worker)
from qmps_torch.circuits import finite_depth as fd
from qmps_torch.circuits import hardware
from qmps_torch.circuits import random as rc
from qmps_torch.circuits.export import kak_decompose, parse_openqasm, to_openqasm, zyz_angles, _u3
from qmps_torch.circuits.ir import circuit_state, circuit_unitary

FACTORIES = (
    ("random_sparse_circuit", dict(length=4, depth=12, seed=3)),
    ("random_circuit", dict(length=4, depth=3, seed=3)),
    ("random_qaoa_circuit", dict(length=4, depth=2, seed=3)),
    ("random_full_rank_circuit", dict(length=4, depth=2, seed=3)),
)


def _t(ops):
    return [(torch.as_tensor(np.asarray(U, complex)), w) for U, w in ops]


def _unitary(ops, n):
    return circuit_unitary(_t(ops), n, dtype=torch.complex128).numpy()


def _rand_u(n, seed):
    rng = np.random.default_rng(seed)
    Q, _ = np.linalg.qr(rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n)))
    return Q


def _is_unitary(U, atol=1e-10):
    U = np.asarray(U)
    return np.allclose(U @ U.conj().T, np.eye(U.shape[0]), atol=atol)


def _round_trip(ops, n, atol=1e-10):
    """Export, parse back, compile both with the port's compiler."""
    qasm, gp = to_openqasm(ops, n)
    ops2, n2 = parse_openqasm(qasm)
    assert n2 == n
    np.testing.assert_allclose(_unitary(ops, n), np.exp(1j * gp) * _unitary(ops2, n), atol=atol)
    return qasm, gp


# -- random circuits (tests/test_random_circuits.py) ----------------------------


@pytest.mark.parametrize("name,kwargs", FACTORIES)
def test_factories_equal_jax_and_compile_to_unitaries(name, kwargs):
    import qmps_tpu.circuits.random as jrc

    ops, ref = getattr(rc, name)(**kwargs), getattr(jrc, name)(**kwargs)
    assert len(ops) == len(ref)
    for (U, w), (V, v) in zip(ops, ref):
        assert tuple(w) == tuple(v)
        np.testing.assert_array_equal(U, V)
    assert all(_is_unitary(U) for U, _ in ops)
    U = _unitary(ops, 4)
    assert _is_unitary(U)
    U3 = _unitary(getattr(rc, name)(**{**kwargs, "seed": 4}), 4)
    assert not np.allclose(U, U3)


def test_su2_from_angles_is_special_unitary():
    U = rc.su2_from_angles(0.3, 1.2, 0.5)
    assert _is_unitary(U, 1e-12)
    np.testing.assert_allclose(np.linalg.det(U), 1.0, atol=1e-12)


def test_full_rank_circuit_has_full_middle_schmidt_rank():
    L = 4
    psi = circuit_state(_t(rc.random_full_rank_circuit(L, depth=3, seed=1)), L, dtype=torch.complex128).numpy()
    s = np.linalg.svd(psi.reshape(2 ** (L // 2), -1), compute_uv=False)
    assert np.min(s) > 1e-3, s


def test_angles_hook_pins_layers():
    angles = [[(0.1, 0.2, 0.3)] * 4] * 2
    a = rc.random_circuit(4, depth=2, seed=0, angles=angles)
    b = rc.random_circuit(4, depth=2, seed=9, angles=angles)
    ones_a = [U for U, w in a if len(w) == 1]
    ones_b = [U for U, w in b if len(w) == 1]
    assert all(np.allclose(x, y) for x, y in zip(ones_a, ones_b))


# -- OpenQASM export (tests/test_export.py) --------------------------------------


def test_zyz_and_kak_reconstruct():
    from scipy.linalg import expm

    for seed in range(10):
        U = _rand_u(2, seed)
        th, ph, la, gp = zyz_angles(U)
        np.testing.assert_allclose(U, np.exp(1j * gp) * _u3(th, ph, la), atol=1e-12)
    X, Y, Z = np.array([[0, 1], [1, 0]]), np.array([[0, -1j], [1j, 0]]), np.diag([1.0, -1.0])
    for seed in range(10):
        U = _rand_u(4, 100 + seed)
        gp, (g0, g1), (a, b, c), (g2, g3) = kak_decompose(U)
        canon = expm(1j * (a * np.kron(X, X) + b * np.kron(Y, Y) + c * np.kron(Z, Z)))
        np.testing.assert_allclose(U, np.exp(1j * gp) * np.kron(g2, g3) @ canon @ np.kron(g0, g1), atol=1e-10)


def _zoo_ops():
    """Op lists of the ansatz zoo, the TDVP circuit and the random factories,
    each as the port builds it (torch gates) and as numpy for the JAX
    exporter."""
    from qmps_torch.circuits import ansatze
    from qmps_torch.objectives.overlap import bell_tdvp_ops
    from qmps_torch.mps import transfer as tr

    rng = np.random.default_rng(0)
    cases = {}
    for name, n_par, D in (("shallow_full_state_ops", 15, None), ("shallow_qaoa_state_ops", 4, 2),
                           ("shallow_cnot_state_ops", 4, 2), ("scars_ansatz_ops", 2, None),
                           ("scar_gate_ops", 4, None)):
        p = torch.tensor(rng.uniform(-2, 2, n_par), dtype=torch.float64)
        cases[name] = getattr(ansatze, name)(*((D, p) if D else (p,)))
    A, B = (torch.from_numpy(a) for a in _torch_parity.left_canonical(rng, 2))
    W = torch.from_numpy(_rand_u(4, 7))
    _, r = tr.right_fixed_point(A, B)
    cases["bell_tdvp"] = (bell_tdvp_ops(A, B, W, r), 6)
    for name, kw in FACTORIES:
        kw = {**kw, "length": 3}
        cases[name] = (getattr(rc, name)(**kw), 3)
    return cases


@pytest.mark.parametrize("case", ["shallow_full_state_ops", "shallow_qaoa_state_ops", "shallow_cnot_state_ops",
                                  "scars_ansatz_ops", "scar_gate_ops", "bell_tdvp", "random_sparse_circuit",
                                  "random_circuit", "random_qaoa_circuit", "random_full_rank_circuit"])
def test_qasm_equals_jax_and_round_trips(case):
    """The port's text equals the JAX exporter's on the same gates, and the
    parsed circuit compiled by the port's circuit_unitary reproduces the
    unitary to 1e-10 up to the returned global phase."""
    from qmps_tpu.circuits.export import to_openqasm as jax_to_openqasm

    ops, n = _zoo_ops()[case]
    ops = [(U.detach().resolve_conj().numpy() if isinstance(U, torch.Tensor) else U, w) for U, w in ops]
    qasm, gp = _round_trip(ops, n)
    ref_qasm, ref_gp = jax_to_openqasm(ops, n)
    assert qasm == ref_qasm
    assert gp == ref_gp


def test_export_round_trips_random_and_special_gates():
    from qmps_torch.core import gates as g

    _round_trip([(_rand_u(4, 1), (0, 1)), (_rand_u(2, 2), (1,)), (_rand_u(4, 3), (1, 2)), (_rand_u(4, 4), (2, 0)),
                 (_rand_u(2, 5), (0,))], 3)
    SWAP = np.eye(4)[[0, 2, 1, 3]].astype(complex)
    _round_trip([(g.H.numpy(), (0,)), (g.CNOT.numpy(), (0, 1)), (SWAP, (1, 2)), (g.CNOT.numpy(), (2, 1)),
                 (np.eye(4, dtype=complex), (0, 2))], 3)


def test_export_rejects_wide_gates():
    with pytest.raises(ValueError):
        to_openqasm([(np.eye(8, dtype=complex), (0, 1, 2))], 3)


# -- hardware-native gates (tests/test_core.py:50-80, test_ansatz_zoo.py:60-71) --


def test_K_and_expYY_gates_equal_their_closed_forms_and_jax():
    import qmps_tpu.circuits.hardware as jhw

    for th in np.random.default_rng(0).uniform(size=4):
        c, s = np.cos(th), np.sin(th)
        K = np.array([[1, 0, 0, 0], [0, c, -1j * s, 0], [0, -1j * s, c, 0], [0, 0, 0, 1]])
        YY = np.array([[c, 0, 0, 1j * s], [0, c, -1j * s, 0], [0, -1j * s, c, 0], [1j * s, 0, 0, c]])
        np.testing.assert_allclose(hardware.K_gate(th).numpy(), K, atol=1e-12)
        np.testing.assert_allclose(hardware.expYY_gate(th).numpy(), YY, atol=1e-12)
        np.testing.assert_allclose(hardware.K_gate(th).numpy(), np.asarray(jhw.K_gate(th)), atol=1e-12)


def _hardware_cases(p3, p4):
    return {
        "V_env_gate": ((p3,), {}),
        "right_environment_gate": ((p3,), {}),
        "CPHASE_gate": ((0.3, 0.2, 0.1, 0.4), {}),
        "TFIM_trotter_gate": ((0.5, 0.3, 0.1, 0.2, 0.15), {}),
        "ry_sqrtiswap_layer_gate": ((2, p4), {}),
    }


@pytest.mark.parametrize("name", ["V_env_gate", "right_environment_gate", "CPHASE_gate", "TFIM_trotter_gate",
                                  "ry_sqrtiswap_layer_gate"])
def test_hardware_gates_match_jax_and_are_unitary(name):
    import qmps_tpu.circuits.hardware as jhw

    rng = np.random.default_rng(1)
    p3, p4 = rng.standard_normal(3), rng.standard_normal(4)
    args, _ = _hardware_cases(p3, p4)[name]
    targs = tuple(torch.tensor(a, dtype=torch.float64) if isinstance(a, np.ndarray) else a for a in args)
    jargs = tuple(jnp.asarray(a) if isinstance(a, np.ndarray) else a for a in args)
    U = getattr(hardware, name)(*targs)
    assert U.dtype == torch.complex128
    np.testing.assert_allclose(U.numpy(), np.asarray(getattr(jhw, name)(*jargs)), atol=1e-12)
    assert _is_unitary(U.numpy(), 1e-12)


def test_hardware_gates_take_the_parameters_type():
    assert hardware.V_env_gate(torch.tensor([0.1, 0.2, 0.3], dtype=torch.float32)).dtype == torch.complex64


@pytest.mark.parametrize("name", ["K_gate", "V_env_gate", "CPHASE_gate", "ry_sqrtiswap_layer_gate"])
def test_hardware_gradients_match_conj_jax_grad(name):
    """A real loss of each parametrised gate: the port's .grad equals JAX's
    gradient (real angles: the conjugate changes nothing), 1e-12."""
    import qmps_tpu.circuits.hardware as jhw

    rng = np.random.default_rng(2)
    M = rng.standard_normal((4, 4)) + 1j * rng.standard_normal((4, 4))
    x = rng.standard_normal({"K_gate": 1, "V_env_gate": 3, "CPHASE_gate": 4, "ry_sqrtiswap_layer_gate": 4}[name])

    def call(mod, p):
        if name == "K_gate":
            return mod.K_gate(p[0])
        if name == "CPHASE_gate":
            return mod.CPHASE_gate(p[0], p[1], p[2], p[3])
        if name == "ry_sqrtiswap_layer_gate":
            return mod.ry_sqrtiswap_layer_gate(2, p)
        return mod.V_env_gate(p)

    g_j = jax.grad(lambda p: jnp.real(jnp.sum(jnp.asarray(M) * call(jhw, p))))(jnp.asarray(x))
    xt = torch.tensor(x, requires_grad=True)
    (torch.from_numpy(M) * call(hardware, xt)).sum().real.backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.conj(np.asarray(g_j)), atol=1e-12)


# -- finite depth (tests/test_capabilities.py:98-135) ----------------------------


def _jax_fd():
    import qmps_tpu.circuits.finite_depth as jfd

    return jfd


def test_ansaetze_match_jax():
    jfd = _jax_fd()
    rng = np.random.default_rng(3)
    for name, n in (("ladder_ansatz", 6), ("real_ansatz", 5), ("real_hermitian_ansatz", 3)):
        p = rng.standard_normal(n)
        U = getattr(fd, name)(torch.tensor(p))
        np.testing.assert_allclose(U.numpy(), np.asarray(getattr(jfd, name)(jnp.asarray(p))), atol=1e-12)
        assert _is_unitary(U.numpy(), 1e-12)


@pytest.mark.parametrize("depth", [2, 3])
def test_staircase_state_normalized_and_matches_jax(depth):
    jfd = _jax_fd()
    p = np.random.default_rng(4).standard_normal(4)
    psi = fd.staircase_state(fd.real_ansatz(torch.tensor(p)), depth=depth)
    np.testing.assert_allclose(float(torch.linalg.vector_norm(psi)), 1.0, atol=1e-10)
    ref = jfd.staircase_state(jfd.real_ansatz(jnp.asarray(p)), depth=depth)
    np.testing.assert_allclose(psi.numpy(), np.asarray(ref), atol=1e-12)


def test_central_expectation_identity_brick():
    from qmps_torch.core.paulis import Z

    psi = fd.staircase_state(torch.eye(4, dtype=torch.complex128), depth=2)
    np.testing.assert_allclose(float(fd.central_expectation(psi, -torch.kron(Z, Z))), -1.0, atol=1e-10)


def test_local_vs_global_overlap_matches_jax():
    jfd = _jax_fd()
    p = np.random.default_rng(5).standard_normal(4)
    U1, U2 = fd.real_ansatz(torch.tensor(p * 0.3)), fd.real_ansatz(torch.tensor(p * 0.3 + 0.05))
    loc, glob = fd.local_global_overlap(U1, U2, depth=2)
    assert float(loc) >= float(glob) - 1e-9
    _, g_self = fd.local_global_overlap(U1, U1, depth=2)
    np.testing.assert_allclose(float(g_self), 1.0, atol=1e-9)
    ref_l, ref_g = jfd.local_global_overlap(jfd.real_ansatz(jnp.asarray(p * 0.3)),
                                            jfd.real_ansatz(jnp.asarray(p * 0.3 + 0.05)), depth=2)
    assert abs(float(glob) - float(ref_g)) < 1e-12
    # the Uhlmann fidelity takes the square root of the eigenvalues of
    # sqrt(r1) r2 sqrt(r1), one of which is rounding (~2e-17 here: the
    # central pair is nearly pure), so each LAPACK adds its own sqrt(eps) ~
    # 4e-9 to the trace (numpy's eigh lands 7.7e-10 from torch's, JAX's
    # 3.3e-10): the local fidelity agrees to sqrt(eps), 1e-8
    assert abs(float(loc) - float(ref_l)) < 1e-8


def test_grow_staircase_and_brick_wall_unitary_match_jax():
    jfd = _jax_fd()
    p = np.random.default_rng(6).standard_normal(4)
    U, W = fd.real_ansatz(torch.tensor(p)), torch.from_numpy(_rand_u(4, 8))
    psi = fd.grow_staircase(U, W, depth=2)
    np.testing.assert_allclose(float(torch.linalg.vector_norm(psi)), 1.0, atol=1e-10)
    Uj = jfd.real_ansatz(jnp.asarray(p))
    np.testing.assert_allclose(psi.numpy(), np.asarray(jfd.grow_staircase(Uj, jnp.asarray(W.numpy()), depth=2)),
                               atol=1e-12)
    np.testing.assert_allclose(fd.brick_wall_unitary(U, 3).numpy(), np.asarray(jfd.brick_wall_unitary(Uj, 3)),
                               atol=1e-12)
    H = torch.from_numpy(_rand_u(4, 9))
    H = (H + H.mH) / 2
    np.testing.assert_allclose(float(fd.central_expectation(psi, H)),
                               float(jfd.central_expectation(jnp.asarray(psi.numpy()), jnp.asarray(H.numpy()))),
                               atol=1e-12)
