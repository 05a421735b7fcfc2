"""The leaves of the ported slices against qmps_tpu at complex128: core
(gates, lie, linalg; tests/test_core.py, 1e-10), embed
(tests/test_embed.py), the cirq-pinned unitaries of
tests/test_reference_parity.py, the ansatz zoo (tests/test_ansatz_zoo.py),
the Hamiltonian models, the circuit-identity battery and circuit
objectives of tests/test_overlap_identities.py, and bricks_from_tensor
(tests/test_brickwork.py)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.linalg import expm

from _torch_parity import to_np
from qmps_torch.circuits import ansatze as tans
from qmps_torch.circuits.ir import circuit_state, circuit_unitary, dagger_ops
from qmps_torch.core import gates as tg
from qmps_torch.core import lie as tlie
from qmps_torch.core import linalg as tla
from qmps_torch.core.paulis import I2, X, Y, Z
from qmps_torch.embed import unitaries as tem
from qmps_torch.ham import hamiltonian as tham
from qmps_torch.mps.imps import Map, iMPS, left_orthogonalise
from qmps_torch.objectives import overlap as tov
from qmps_tpu.circuits import ansatze as jans
from qmps_tpu.core import gates as jg
from qmps_tpu.core import lie as jlie
from qmps_tpu.core import linalg as jla
from qmps_tpu.embed import unitaries as jem
from qmps_tpu.ham import hamiltonian as jham
from qmps_tpu.objectives import overlap as jov
from test_reference_parity import CNOT_D2_4, P4, P6, P15, QAOA_D2_4, SFST_15, STATE_GATE_6, VR_6

ATOL = 1e-10
PAULIS = [I2, X, Y, Z]


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(t, j, atol=ATOL):
    np.testing.assert_allclose(to_np(t) if isinstance(t, torch.Tensor) else t, np.asarray(j), rtol=0, atol=atol)


def unitary_err(U):
    U = to_np(U) if isinstance(U, torch.Tensor) else np.asarray(U)
    return np.linalg.norm(U.conj().T @ U - np.eye(U.shape[0]))


def _random(seed, *shape):
    rng = np.random.default_rng(seed)
    return rng.standard_normal(shape) + 1j * rng.standard_normal(shape)


# -- core/gates -----------------------------------------------------------------


@pytest.mark.parametrize("name", ["x_pow", "z_pow", "xx_pow", "yy_pow", "zz_pow", "cnot_pow", "cry", "iswap_pow",
                                  "rx", "ry", "rz"])
def test_gates_match_jax(name):
    """Each gate at three angles, and batched over them, against JAX's."""
    ts = np.array([0.37, -1.2, 2.7])
    for t in ts:
        _close(getattr(tg, name)(float(t)), getattr(jg, name)(t), atol=1e-12)
    batched = to_np(getattr(tg, name)(_t(ts)))
    np.testing.assert_allclose(batched, np.stack([np.asarray(getattr(jg, name)(t)) for t in ts]), atol=1e-12)
    assert getattr(tg, name)(_t(ts).float()).dtype == torch.complex64


def test_gates_cirq_conventions():
    """tests/test_core.py:19-48: rotations are expm(-i t P / 2), X^1 = X,
    X^0 = I, ZZ^t = diag(1, e^{i pi t}, e^{i pi t}, 1), iSWAP^1 maps |01>
    to i|10>; the sqrt-iSWAP constants are JAX's."""
    for t in (0.3, -1.2, 2.7):
        for gate, P in ((tg.rx, X), (tg.ry, Y), (tg.rz, Z)):
            _close(gate(t), expm(-1j * t * P.numpy() / 2), atol=1e-12)
    _close(tg.x_pow(1.0), X.numpy(), atol=1e-12)
    _close(tg.x_pow(0.0), np.eye(2), atol=1e-12)
    t = 0.37
    _close(tg.zz_pow(t), np.diag([1, np.exp(1j * np.pi * t), np.exp(1j * np.pi * t), 1]), atol=1e-12)
    expected = np.eye(4, dtype=complex)
    expected[1, 1] = expected[2, 2] = 0
    expected[1, 2] = expected[2, 1] = 1j
    _close(tg.iswap_pow(1.0), expected, atol=1e-12)
    assert unitary_err(tg.iswap_pow(0.5)) < 1e-12
    _close(tg.SQRT_ISWAP, jg.SQRT_ISWAP, atol=0)
    _close(tg.SQRT_ISWAP_INV, jg.SQRT_ISWAP_INV, atol=0)


# -- core/lie ---------------------------------------------------------------------


def test_lie_closed_forms_match_jax():
    """U2f, U4_kak (19 params), U4_state (9 params, and 7 zero-padded):
    JAX's to 1e-10, unitary or normalised (tests/test_core.py:99-110)."""
    _close(tlie.U2f(0.3, 1.1, -0.7, 2.2), jlie.U2f(0.3, 1.1, -0.7, 2.2))
    assert unitary_err(tlie.U2f(0.3, 1.1, -0.7, 2.2)) < 1e-12
    p = np.random.default_rng(5).standard_normal(19)
    _close(tlie.U4_kak(_t(p)), jlie.U4_kak(jnp.asarray(p)))
    assert unitary_err(tlie.U4_kak(_t(p))) < 1e-10
    for n in (9, 7):
        p = np.random.default_rng(6).standard_normal(n)
        _close(tlie.U4_state(_t(p)), jlie.U4_state(jnp.asarray(p)))
        assert abs(np.linalg.norm(to_np(tlie.U4_state(_t(p)))) - 1) < 1e-10
    ab = _t(np.array([[0.3, 1.1, -0.7, 2.2], [0.5, -0.2, 0.9, 0.1]]))
    batched = to_np(tlie.U2f(*ab.T))
    np.testing.assert_allclose(batched, np.stack([np.asarray(jlie.U2f(*r)) for r in np.asarray(ab)]), atol=1e-12)


def test_su_parameter_helpers_match_jax():
    """extract (round trip to 1e-8, tests/test_core.py:135-139), the D ->
    2D embedding and its linear batched form: JAX's values."""
    v = np.random.default_rng(8).standard_normal(15) * 0.3
    U = to_np(tlie.SU(_t(v), 4))
    v2 = tlie.extract_su_params(U)
    np.testing.assert_allclose(v2, jlie.extract_su_params(U), atol=1e-12)
    _close(tlie.SU(_t(v2), 4), U, atol=1e-8)
    np.testing.assert_allclose(tlie.embed_su_params(v), jlie.embed_su_params(v), atol=ATOL)
    vs = np.random.default_rng(9).standard_normal((3, 15)) * 0.3
    np.testing.assert_allclose(tlie.grow_su_params(vs), jlie.grow_su_params(vs), atol=1e-12)
    # the linear map is the log-free form of the embedding
    np.testing.assert_allclose(tlie.grow_su_params(v), tlie.embed_su_params(v), atol=1e-8)


# -- core/linalg ------------------------------------------------------------------


def test_completions_match_jax():
    """tests/test_core.py:143-165: the QR completions keep the isometry's
    columns (rows), are unitary and equal JAX's (the same filler);
    batched, each element is the unbatched one; differentiable."""
    iso, _ = np.linalg.qr(_random(0, 8, 3))
    U = tla.unitary_completion(_t(iso))
    _close(U, jla.unitary_completion(jnp.asarray(iso)))
    _close(to_np(U)[:, :3], iso)
    assert unitary_err(U) < 1e-10
    rows = np.linalg.qr(_random(1, 4, 2))[0].conj().T
    R = tla.row_completion(_t(rows))
    _close(R, jla.row_completion(jnp.asarray(rows)))
    _close(to_np(R)[:2], rows)
    isos = np.stack([np.linalg.qr(_random(s, 4, 2))[0] for s in (2, 3)])
    Ub = to_np(tla.unitary_completion(_t(isos)))
    for k in range(2):
        _close(Ub[k], tla.unitary_completion(_t(isos[k])), atol=1e-12)
    x = torch.tensor(0.3, dtype=torch.float64, requires_grad=True)
    iso1 = torch.stack([torch.cos(x), torch.sin(x), torch.zeros_like(x), torch.zeros_like(x)]).reshape(4, 1)
    (tla.unitary_completion(iso1.to(torch.complex128)).abs() ** 2).sum().backward()
    assert torch.isfinite(x.grad)


def test_linalg_helpers_match_jax():
    """polar, rotate_to_hermitian, direct_sum, the real-vector round trip,
    eye_like, frob_norm and random_unitary (tests/test_core.py:167-183)."""
    A = _random(3, 4, 4)
    U, P = tla.polar(_t(A))
    for t, j in zip((U, P), jla.polar(jnp.asarray(A))):
        _close(t, j)
    _close(U @ P, A)
    h = _random(2, 3, 3)
    h = h + h.conj().T + 6 * np.eye(3)
    _close(tla.rotate_to_hermitian(_t(np.exp(1j * 1.234) * h)), h)
    B = _random(4, 2, 3)
    _close(tla.direct_sum(_t(A), _t(B)), jla.direct_sum(jnp.asarray(A), jnp.asarray(B)), atol=0)
    v = tla.to_real_vector(_t(B))
    _close(v, jla.to_real_vector(jnp.asarray(B)), atol=0)
    _close(tla.from_real_vector(v), jla.from_real_vector(jnp.asarray(to_np(v))), atol=0)
    _close(tla.eye_like(_t(A)), np.eye(4), atol=0)
    assert abs(float(tla.frob_norm(_t(A))) - float(jla.frob_norm(jnp.asarray(A)))) < 1e-12
    Q = tla.random_unitary(torch.Generator().manual_seed(0), 5)
    assert Q.shape == (5, 5) and unitary_err(Q) < 1e-12


def test_nsphere_and_split_ns():
    """tests/test_core.py:186-211: the cumprod form against the recursion
    (unit norm), a zero gradient of the norm, and the chunking."""
    rng = np.random.default_rng(7)
    for n in (1, 2, 5, 8):
        v = rng.uniform(0, np.pi, n)
        ref = np.array([np.prod(np.sin(v[:k])) * np.cos(v[k]) for k in range(n)] + [np.prod(np.sin(v))])
        _close(tla.nsphere(_t(v)), ref, atol=1e-12)
        _close(tla.nsphere(_t(v)), jla.nsphere(jnp.asarray(v)), atol=1e-12)
    x = torch.ones(4, dtype=torch.float64, requires_grad=True)
    (tla.nsphere(x) ** 2).sum().backward()
    np.testing.assert_allclose(x.grad.numpy(), 0.0, atol=1e-12)
    _close(tla.split_ns(torch.arange(6.0), 2), [[0, 1], [2, 3], [4, 5]], atol=0)
    with pytest.raises(ValueError, match="multiple"):
        tla.split_ns(torch.arange(5.0), 2)


# -- embed ---------------------------------------------------------------------------


@pytest.mark.parametrize("D", [2, 4, 8])
def test_tensor_unitary_roundtrip(D):
    """tests/test_embed.py:24-35, and the unitary equals JAX's."""
    A = _random(10 + D, 2, D, D)
    AL = left_orthogonalise(_t(A))[0]
    U = tem.tensor_to_unitary(AL)
    _close(U, jem.tensor_to_unitary(jnp.asarray(to_np(AL))))
    assert unitary_err(U) < 1e-10
    _close(to_np(U)[:, :D], to_np(AL).transpose(1, 0, 2).reshape(2 * D, D))
    _close(tem.unitary_to_tensor(U), to_np(AL))


def test_environment_unitary_roundtrip():
    v = _random(20, 4)
    U = tem.environment_to_unitary(_t(v))
    _close(U, jem.environment_to_unitary(jnp.asarray(v)))
    assert unitary_err(U) < 1e-10
    _close(tem.environment_from_unitary(U).reshape(-1), v / np.linalg.norm(v))


def test_put_env_roundtrips_match_jax():
    """tests/test_embed.py:46-62 (20 random q), each embedding JAX's; and
    differentiable (:65-75)."""
    rng = np.random.default_rng(42)
    for _ in range(20):
        q = rng.standard_normal((2, 2)) + 1j * rng.standard_normal((2, 2))
        for put, get, jput in ((tem.put_env_on_left_site, tem.get_env_off_left_site, jem.put_env_on_left_site),
                               (tem.put_env_on_right_site, tem.get_env_off_right_site, jem.put_env_on_right_site)):
            A, n = put(_t(q), ret_n=True)
            Aj, nj = jput(jnp.asarray(q), ret_n=True)
            _close(A, Aj)
            assert abs(float(n) - float(nj)) < 1e-12 and unitary_err(A) < 1e-10
            _close(get(A * n), q)
    x = torch.from_numpy(rng.standard_normal(8)).requires_grad_()
    (tem.put_env_on_left_site(torch.complex(x[:4], x[4:]).reshape(2, 2)).abs() ** 2).sum().backward()
    assert torch.isfinite(x.grad).all()


# -- the reference-pinned unitaries and the ansatz zoo ---------------------------------


@pytest.mark.parametrize("name", ["full15", "state_gate", "env_vr", "qaoa", "cnot"])
def test_reference_unitaries(name):
    """tests/test_reference_parity.py's literals, derived from the
    reference's cirq decompositions, to 1e-10."""
    p15, p6, p4 = (_t(np.asarray(p)) for p in (P15, P6, P4))
    got, want = {
        "full15": (tans.shallow_full_state(p15), SFST_15),
        "state_gate": (tans.state_gate(p6), STATE_GATE_6),
        "env_vr": (tans.env_vr(p6), VR_6),
        "qaoa": (tans.shallow_qaoa_state(2, p4), QAOA_D2_4),
        "cnot": (tans.shallow_cnot_state(2, p4), CNOT_D2_4),
    }[name]
    _close(got, want)


@pytest.mark.parametrize("name,D,n_par", [
    ("qaoa", 2, 4), ("qaoa", 4, 4), ("cnot", 2, 4), ("cnot", 4, 6), ("cnot_nonuniform", 2, 8), ("cnot3", 2, 6),
    ("exact_after_4", 2, 12), ("full15", 2, 15), ("su4", 2, 15), ("suN", 4, 63),
])
def test_state_ansatze_match_jax(name, D, n_par):
    """tests/test_ansatz_zoo.py's cases: unitary, JAX's unitary, and (a
    batch of two) each element the unbatched one."""
    p = np.random.default_rng(n_par).standard_normal((2, n_par)) * 0.4
    U = tans.STATE_ANSATZE[name](D, _t(p[0]))
    assert U.shape == (2 * D, 2 * D) and unitary_err(U) < 1e-9
    _close(U, jans.STATE_ANSATZE[name](D, jnp.asarray(p[0])))
    Ub = tans.STATE_ANSATZE[name](D, _t(p))
    _close(Ub[1], tans.STATE_ANSATZE[name](D, _t(p[1])), atol=1e-12)
    if name in tans.STATE_ANSATZE_OPS:
        ops, n = tans.STATE_ANSATZE_OPS[name](D, _t(p[0]))
        _close(circuit_unitary(ops, n), U, atol=1e-12)


def test_env_and_scars_ansatze_match_jax():
    """tests/test_ansatz_zoo.py:35-58: the environment, state and scars
    gates are unitary and JAX's; scars_tensor is JAX's."""
    p6 = np.asarray(jax.random.normal(jax.random.PRNGKey(0), (6,)))
    p4 = p6[:4]
    for name, args in (("env_vr", (p6,)), ("state_gate", (p6,)), ("shallow_env", (4, p4)), ("scar_gate", (p4,)),
                       ("scars_ansatz", (p4[:2],))):
        U = getattr(tans, name)(*(_t(a) if isinstance(a, np.ndarray) else a for a in args))
        assert unitary_err(U) < 1e-9, name
        _close(U, getattr(jans, name)(*(jnp.asarray(a) if isinstance(a, np.ndarray) else a for a in args)))
    _close(tans.scars_tensor(0.3, 0.7), jans.scars_tensor(0.3, 0.7), atol=0)


# -- ham/hamiltonian ------------------------------------------------------------------


def test_hamiltonian_models_match_jax():
    for t, j in ((tham.xy(), jham.xy()), (tham.heisenberg(0.7), jham.heisenberg(0.7)),
                 (tham.xxz(1.5), jham.xxz(1.5))):
        np.testing.assert_array_equal(t.to_matrix(), j.to_matrix())
    h1 = np.diag([0.3, -0.3])
    for h in (tham.tfim(0.7), tham.heisenberg()):
        hj = jham.Hamiltonian(h.strings)
        np.testing.assert_array_equal(tham.sublattice_rotate(h), jham.sublattice_rotate(hj))
        np.testing.assert_array_equal(tham.block_two_site(h), jham.block_two_site(hj))
        np.testing.assert_array_equal(tham.block_two_site(h, h1), jham.block_two_site(hj, h1))
    np.testing.assert_array_equal(tham.scars_H(0.4), jham.scars_H(0.4))
    m = _random(30, 4, 4)
    m = m + m.conj().T
    st, sj = tham.Hamiltonian.from_matrix(m).strings, jham.Hamiltonian.from_matrix(m).strings
    assert st.keys() == sj.keys() and max(abs(st[k] - sj[k]) for k in st) < 1e-12
    # the projection drops the identity string
    np.testing.assert_allclose(tham.Hamiltonian(st).to_matrix(), m - np.trace(m) / 4 * np.eye(4), atol=1e-12)
    psi = _random(31, 16)
    psi /= np.linalg.norm(psi)
    for loc in (0, 1, 2):
        e = tham.tfim(0.7).calculate_energy(_t(psi), loc)
        assert abs(float(e) - float(jham.tfim(0.7).calculate_energy(jnp.asarray(psi), loc))) < 1e-12


# -- objectives/overlap: the circuit-identity battery ----------------------------------


@pytest.fixture(scope="module")
def states():
    """tests/test_overlap_identities.py's two left-canonical D = 2 states,
    JAX's own draws."""
    from qmps_tpu.mps.imps import iMPS as jiMPS

    return tuple(_t(jiMPS.random(jax.random.PRNGKey(k), 2, 2).left_canonicalise()[0]) for k in (0, 1))


def _amp(ops, n):
    return complex(circuit_state(ops, n)[0])


def test_env_readout_identities(states):
    """tests/test_overlap_identities.py:44-179 through the port's
    embeddings and circuit compiler: 2 psi[0] = Tr(P r), x Tr(P r),
    x^2 Tr(P r), Tr(P l*), x Tr(P l*) and the full sandwich x^2 Tr(l^dag r)."""
    A, B = states
    x, r = Map(A, B).right_fixed_point()
    _, l = Map(A, B).left_fixed_point()
    x, r, l = complex(x), to_np(r), to_np(l)
    U, Ud = tem.tensor_to_unitary(A), tem.tensor_to_unitary(B)
    R = tem.put_env_on_left_site(_t(r))
    L = tem.put_env_on_right_site(_t(l.conj().T))
    for P in PAULIS:
        Pn = P.numpy()
        bell = [(tg.H, (1,)), (tg.CNOT, (1, 2))]
        unbell = [(tg.CNOT, (1, 2)), (tg.H, (1,))]
        np.testing.assert_allclose(2 * _amp(bell + [(R, (2, 3)), (P, (1,))] + unbell, 4), np.trace(Pn @ r),
                                   atol=1e-8)
        ops = bell + [(U, (0, 1)), (R, (2, 3)), (P, (0,))] + dagger_ops([(Ud, (0, 1))]) + unbell
        np.testing.assert_allclose(2 * _amp(ops, 4), x * np.trace(Pn @ r), atol=1e-8)
        ops = ([(tg.H, (2,)), (tg.CNOT, (2, 3)), (U, (1, 2)), (U, (0, 1)), (R, (3, 4)), (P, (0,))]
               + dagger_ops([(Ud, (0, 1))]) + dagger_ops([(Ud, (1, 2))]) + [(tg.CNOT, (2, 3)), (tg.H, (2,))])
        np.testing.assert_allclose(2 * _amp(ops, 5), x ** 2 * np.trace(Pn @ r), atol=1e-8)
        np.testing.assert_allclose(2 * _amp(bell + [(L, (0, 1)), (P, (2,))] + unbell, 3),
                                   np.trace(Pn @ l.conj()), atol=1e-8)
        ops = ([(tg.H, (2,)), (tg.CNOT, (2, 3)), (U, (1, 2)), (L, (0, 1)), (P, (3,))]
               + dagger_ops([(Ud, (1, 2))]) + [(tg.CNOT, (2, 3)), (tg.H, (2,))])
        np.testing.assert_allclose(2 * _amp(ops, 4), x * np.trace(Pn @ l.conj()), atol=1e-8)
    ops = ([(tg.H, (3,)), (tg.CNOT, (3, 4)), (U, (2, 3)), (U, (1, 2)), (L, (0, 1)), (R, (4, 5))]
           + dagger_ops([(Ud, (1, 2))]) + dagger_ops([(Ud, (2, 3))]) + [(tg.CNOT, (3, 4)), (tg.H, (3,))])
    np.testing.assert_allclose(2 * _amp(ops, 6), x ** 2 * np.trace(l.conj().T @ r), atol=1e-8)


def test_circuit_objectives_match_jax(states):
    """tests/test_overlap_identities.py:182-211: the circuit objective
    equals the fast one and JAX's; the amplitude is x; W = I and B = A give
    -1; the exact overlap is JAX's."""
    A, B = states
    An, Bn = jnp.asarray(to_np(A)), jnp.asarray(to_np(B))
    W = expm(-1j * tham.Hamiltonian({"ZZ": -1.0, "X": 1.0}).to_matrix() * 0.05)
    circ = tov.tdvp_objective_circuit(A, B, _t(W))
    assert abs(float(circ) - float(tov.tdvp_objective(A, B, _t(W)))) < 1e-8
    assert abs(float(circ) - float(jov.tdvp_objective_circuit(An, Bn, W))) < 1e-10
    eye = torch.eye(4, dtype=torch.complex128)
    WAA, BB = tov.mixed_transfer_with_gate(A, B, eye)
    x, r = Map(WAA, BB).right_fixed_point()
    np.testing.assert_allclose(complex(tov.hadamard_test_amplitude(A, B, eye, r)), complex(x), atol=1e-8)
    assert abs(float(tov.tdvp_objective(A, A, eye)) + 1) < 1e-9
    ops_t, ops_j = tov.bell_tdvp_ops(A, B, eye, r), jov.bell_tdvp_ops(An, Bn, np.eye(4), jnp.asarray(to_np(r)))
    assert [w for _, w in ops_t] == [w for _, w in ops_j]
    for (Ut, _), (Uj, _) in zip(ops_t, ops_j):
        _close(Ut, Uj)
    (ov, r_t), (ov_j, r_j) = tov.get_overlap_exact(A, B), jov.get_overlap_exact(An, Bn)
    _close(ov, ov_j)
    _close(r_t, r_j)


def test_variational_overlap_reaches_jaxs(states):
    """get_overlap_variational: torch's draw of the 8 environment
    parameters is not JAX's, so the value reached is held (1e-8), not the
    path; the environment has unit norm."""
    A, B = states
    amp, r = tov.get_overlap_variational(A, B, steps=300)
    amp_j, _ = jov.get_overlap_variational(jnp.asarray(to_np(A)), jnp.asarray(to_np(B)), steps=300)
    assert abs(float(amp) - float(amp_j)) < 1e-8
    assert abs(np.linalg.norm(to_np(r)) - 1) < 1e-12


# -- circuits/brickwork.bricks_from_tensor ---------------------------------------------


def test_bricks_from_tensor_matches_jax():
    """tests/test_brickwork.py:153-167: genuine unitaries, deterministic,
    and JAX's bricks."""
    from qmps_torch.circuits.brickwork import bricks_from_tensor
    from qmps_tpu.circuits.brickwork import bricks_from_tensor as jbricks
    from qmps_tpu.mps.imps import iMPS as jiMPS, random_tensor

    A = np.array(jiMPS([random_tensor(jax.random.PRNGKey(0), 2, 2)]).left_canonicalise()[0])
    U1, U2 = bricks_from_tensor(_t(A))
    for U in (U1, U2):
        np.testing.assert_allclose(to_np(U @ U.mH), np.eye(4), atol=1e-12)
    U1b, _ = bricks_from_tensor(_t(A))
    _close(U1, U1b, atol=1e-14)
    for t, j in zip((U1, U2), jbricks(jnp.asarray(A))):
        _close(t, j)
    assert iMPS([_t(A)]).D == 2
