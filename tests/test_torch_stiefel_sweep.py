"""qmps_torch's large-D phase-diagram sweep (sweep_ground_states_stiefel,
its programs, _polar_ns, grow_isometry) against qmps_tpu's, at complex128
on the CPU, and the port's own gates.  Mirrors tests/test_stiefel_sweep.py
with its sizes and tolerances.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import to_np
from qmps_torch.ham.exact import tfim_gs_energy_f64
from qmps_torch.mps.imps import iMPS
from qmps_torch.mps.transfer import transfer_dense
from qmps_torch.optim.riemann import isometry_energy_warm
from qmps_torch.parallel import sweep as tsw
from qmps_tpu.parallel import sweep as jsw


def _sweep(gv, **kw):
    return tsw.sweep_ground_states_stiefel(torch.from_numpy(np.asarray(gv, np.float64)), **kw)


def test_polar_ns_matches_svd_polar():
    """The Newton-Schulz polar factor is the SVD polar factor (5e-6) in the
    near-isometric regime, and JAX's (1e-12)."""
    rng = np.random.default_rng(0)
    W = rng.standard_normal((3, 8, 4)) + 1j * rng.standard_normal((3, 8, 4))
    W = np.linalg.qr(W)[0] + 0.1 * rng.standard_normal((3, 8, 4))
    V = to_np(tsw._polar_ns(torch.from_numpy(W), iters=18))
    u, _, vh = np.linalg.svd(W, full_matrices=False)
    np.testing.assert_allclose(V, u @ vh, atol=5e-6)
    for Vb in V:
        np.testing.assert_allclose(Vb.conj().T @ Vb, np.eye(4), atol=5e-6)
    np.testing.assert_allclose(V, np.asarray(jsw._polar_ns(jnp.asarray(W), iters=18)), atol=1e-12)


def test_programs_match_jax_from_the_same_normals():
    """init / advance / finish from the same numpy normals, D = 4, 4 points
    x 2 restarts, 40 steps: V, M, r, the energies, As and rs equal JAX's
    to 1e-10 (reached: ~1e-13).  The port's ``finish`` departs from JAX's
    fixed-count readout (200 matvecs from the carried environment): it
    projects that environment onto the dominant eigenspace first
    (``sweep._dominant_environment``).  Both reach the same fixed point
    here, where the matvecs converge; they part where the transfer
    spectrum is near-degenerate (``test_unconverged_readout_can_read_below_exact``)."""
    D, R, n, steps = 4, 2, 4, 40
    rng = np.random.default_rng(3)
    gs = np.linspace(0.5, 1.5, n)
    xre, xim = rng.standard_normal((2, n * R, 2 * D, D))
    j_init, j_make_advance, j_finish = jsw._stiefel_sweep_programs(D, 0.08, 0.9, R, 24, 200, jnp.float64, None)
    t_init, t_advance, t_finish = tsw._stiefel_sweep_programs(D, 0.08, 0.9, R, 24, 200)
    j = j_init(jnp.asarray(gs), jnp.asarray(xre), jnp.asarray(xim), None)
    t = t_init(*(torch.from_numpy(x) for x in (gs, xre, xim)))
    for a, b in zip(t, j):
        np.testing.assert_allclose(to_np(a), np.asarray(b), atol=1e-14)
    hs_j, hs_t = j[0], t[0]
    j = j_make_advance(steps)(*j[1:], hs_j)
    t = t_advance(*t[1:], hs_t, steps)
    for a, b in zip(t, j):
        np.testing.assert_allclose(to_np(a), np.asarray(b), atol=1e-10)
    for a, b in zip(t_finish(t[0], t[2], hs_t), j_finish(j[0], j[2], hs_j)):
        np.testing.assert_allclose(to_np(a), np.asarray(b), atol=1e-10)


def test_stiefel_sweep_converges():
    """8 points, D = 4, 200 steps: median < 5e-4, max < 5e-3, never below
    the exact energy by more than 1e-4 (test_stiefel_sweep.py:50-55)."""
    gv = np.linspace(0.3, 1.8, 8)
    es, As, rs = _sweep(gv, D=4, steps=200)
    err = to_np(es) - tfim_gs_energy_f64(gv)
    assert As.shape == (8, 2, 4, 4) and rs.shape == (8, 4, 4) and es.dtype == torch.float64
    assert np.all(np.isfinite(err))
    assert np.median(err) < 5e-4
    assert np.max(err) < 5e-3
    assert np.min(err) > -1e-4


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_stiefel_sweep_returns_left_canonical_tensors(dtype):
    """Left-canonical to 1e-5 in either precision; a float32 gs runs the
    sweep in complex64 (the card's type) on the CPU."""
    _, As, _ = tsw.sweep_ground_states_stiefel(torch.tensor([1.0, 1.3], dtype=dtype), D=4, steps=120)
    assert As.dtype == (torch.complex128 if dtype == torch.float64 else torch.complex64)
    A = to_np(As).astype(np.complex128)
    gram = np.einsum("bsij,bsik->bjk", A.conj(), A)
    np.testing.assert_allclose(gram, np.broadcast_to(np.eye(4), gram.shape), atol=1e-5)


def test_grow_isometry_preserves_energy_and_feeds_warm_start():
    """grow_isometry embeds a converged D = 4 state into D = 8 with an
    O(eps) energy change (5e-3), and the warm-started D = 8 sweep never
    loses to the D = 4 optimum (1e-4) nor goes below exact (1e-4)."""
    gv = np.array([0.9, 1.2])
    es4, As, _ = _sweep(gv, D=4, steps=200)
    V8 = tsw.grow_isometry(As, eps=1e-4)
    assert V8.shape == (2, 16, 8)
    for b in range(2):
        A8 = V8[b].reshape(8, 2, 8).transpose(0, 1)
        e8 = float(iMPS([A8]).energy(tsw.tfim_matrix(torch.tensor(gv[b])).to(A8.dtype)))
        assert abs(e8 - float(es4[b])) < 5e-3
    es8, _, _ = _sweep(gv, D=8, steps=120, warm_V=V8)
    assert np.all(to_np(es8) <= to_np(es4) + 1e-4)
    assert np.all(to_np(es8) - tfim_gs_energy_f64(gv) > -1e-4)


def test_grow_isometry_without_noise_matches_jax():
    """At eps = 0 the embedding is deterministic: the port's grown isometry
    equals JAX's (1e-12), batched and for one tensor."""
    rng = np.random.default_rng(2)
    x = rng.standard_normal((3, 8, 4)) + 1j * rng.standard_normal((3, 8, 4))
    A = np.linalg.qr(x)[0].reshape(3, 4, 2, 4).transpose(0, 2, 1, 3).copy()
    V = to_np(tsw.grow_isometry(torch.from_numpy(A), eps=0.0))
    np.testing.assert_allclose(V, np.asarray(jsw.grow_isometry(jnp.asarray(A), eps=0.0)), atol=1e-12)
    V1 = to_np(tsw.grow_isometry(torch.from_numpy(A[0]), eps=0.0))
    np.testing.assert_allclose(V1, V[0], atol=1e-15)


def test_stiefel_two_phase_schedule_matches_single_phase():
    """precision / polish_steps split the descent into a tier and a full
    float32 tail; on the CPU the tier changes no product, so the schedule
    reproduces the single phase exactly (1e-9 / 1e-7, as JAX holds it),
    and polish_steps clamps to [0, steps]."""
    gv = np.array([0.7, 1.4])
    es0, As0, _ = _sweep(gv, D=4, steps=60)
    es2, As2, _ = _sweep(gv, D=4, steps=60, precision="default", polish_steps=20)
    np.testing.assert_allclose(to_np(es2), to_np(es0), atol=1e-9)
    np.testing.assert_allclose(to_np(As2), to_np(As0), atol=1e-7)
    es3, _, _ = _sweep(gv, D=4, steps=60, precision="default", polish_steps=999)
    np.testing.assert_allclose(to_np(es3), to_np(es0), atol=1e-9)


def test_matmul_tier_restores_the_pin():
    """"default" turns one-pass TF32 on inside and restores the package's
    full-float32 pin on exit, also after an exception; an unknown tier
    raises."""
    pin = (torch.get_float32_matmul_precision(), torch.backends.cuda.matmul.allow_tf32)
    assert pin == ("highest", False)
    with tsw._matmul_tier("default"):
        assert torch.get_float32_matmul_precision() == "high" and torch.backends.cuda.matmul.allow_tf32
    with pytest.raises(KeyError), tsw._matmul_tier("default"):
        raise KeyError
    for tier in (None, "highest", "high"):
        with tsw._matmul_tier(tier):
            assert (torch.get_float32_matmul_precision(), torch.backends.cuda.matmul.allow_tf32) == pin
    assert (torch.get_float32_matmul_precision(), torch.backends.cuda.matmul.allow_tf32) == pin
    with pytest.raises(ValueError, match="precision"), tsw._matmul_tier("bfloat16"):
        pass


def test_slot_starts_nest_and_ignore_point_chunk():
    """Slot s's start depends on the seed and s only: the restarts=1 draw
    is slot 0 of the restarts=3 draw, and the sweep's result does not
    depend on point_chunk (chunks of 2 and 3 equal one batch, 1e-12)."""
    re1, im1 = tsw._nested_restart_normals(5, 1, (4, 8, 4))
    re3, im3 = tsw._nested_restart_normals(5, 3, (4, 8, 4))
    assert torch.equal(re1[:, 0], re3[:, 0]) and torch.equal(im1[:, 0], im3[:, 0])
    assert not torch.equal(re3[:, 0], re3[:, 1]) and not torch.equal(re3[:, 0], im3[:, 0])
    gv = np.linspace(0.5, 1.5, 5)
    full = _sweep(gv, D=3, steps=15, restarts=2)
    for chunk in (2, 3):
        for a, b in zip(_sweep(gv, D=3, steps=15, restarts=2, point_chunk=chunk), full):
            torch.testing.assert_close(a, b, atol=1e-12, rtol=0)


def test_point_chunk_rule_counts_the_saved_tensors():
    """SAVED_PER_ITER is what autograd keeps per warm iteration and point:
    the saved bytes of the descent's loss grow by SAVED_PER_ITER complex
    (D, D) tensors a point per added iteration (D = 8, 16 points, 24 ->
    96 iterations); on the CPU the rule takes every point at once."""
    D, B = 8, 16
    V = torch.linalg.qr(torch.randn(B, 2 * D, D, dtype=torch.complex64))[0].requires_grad_()
    hs = tsw.tfim_matrix(torch.linspace(0.5, 1.5, B))
    r0 = torch.eye(D, dtype=V.dtype).expand(B, D, D) / D ** 0.5

    def saved_bytes(iters):
        storages = {}

        def pack(t):
            storages[t.untyped_storage().data_ptr()] = t.untyped_storage().nbytes()
            return t

        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            isometry_energy_warm(V, hs, D, r0, iters, "unroll")
        return sum(storages.values())

    per_iter = (saved_bytes(96) - saved_bytes(24)) / (72 * B * D * D * V.element_size())
    assert abs(per_iter - tsw.SAVED_PER_ITER) < 0.5, per_iter
    assert tsw.stiefel_point_chunk(1024, 32, 1, 96, torch.complex64, "cpu") == 1024


def test_unconverged_readout_can_read_below_exact():
    """A fixed-count warm power readout (recycle_iters in the descent, a few
    matvecs at the end) can lie below the exact energy: a descent that
    follows an unconverged readout reaches states whose transfer spectrum
    is near-degenerate (|lam_2/lam_1| > 0.9998 here), where matvecs from
    the carried environment converge too slowly (chip_smoke.py phase 14
    saw two of 1,024 D = 32 points up to 4.19e-4 below exact on the card).
    At D = 8, recycle_iters 4, the g = 1 point's readout of 8 matvecs reads
    more than 1e-3 below exact; a 2,000-iteration readout and the host
    float64 readout of the same state lie above it.  The sweep's own
    readout (``finish``: the carried environment projected onto the
    dominant eigenspace, then the matvecs) lies above exact and equals the
    host float64 readout to 1e-10."""
    from qmps_torch.utils.host_eval import host_f64_sweep_energies, tfim_h64_batch

    D, gv = 8, np.array([0.97, 0.99, 1.0, 1.01, 1.03])
    gs = torch.from_numpy(gv)
    seed = int(torch.randint(0, 2 ** 62, (1,), generator=torch.Generator().manual_seed(0)))
    xre, xim = (x.reshape(5, 2 * D, D) for x in tsw._nested_restart_normals(seed, 1, (5, 2 * D, D)))
    init, advance, finish = tsw._stiefel_sweep_programs(D, 0.08, 0.9, 1, 4, 8)
    hs, V, M, r = init(gs, xre, xim)
    V, _, r = advance(V, M, r, hs, 200)
    fixed = to_np(isometry_energy_warm(V, hs, D, r, 8, "unroll")[0])
    exact = tfim_gs_energy_f64(gv)
    i = int(np.argmin(fixed - exact))
    assert fixed[i] - exact[i] < -1e-3
    es, As, rs = finish(V, r, hs)
    assert torch.equal(As, V.reshape(-1, D, 2, D).transpose(1, 2))
    mods = np.sort(np.abs(np.linalg.eigvals(to_np(transfer_dense(As[i], As[i])))))
    assert mods[-2] / mods[-1] > 0.9998
    deep = to_np(isometry_energy_warm(V, hs, D, r, 2000, "unroll")[0])
    e64 = host_f64_sweep_energies(to_np(As), to_np(rs), tfim_h64_batch(gv))[0]
    assert deep[i] > exact[i] and np.all(e64 > exact)
    assert np.all(to_np(es) > exact)
    np.testing.assert_allclose(to_np(es), e64, rtol=0, atol=1e-10)


@pytest.mark.slow
def test_stiefel_restarts_pick_best_basin():
    gv = np.linspace(0.2, 2.0, 6)
    es1, _, _ = _sweep(gv, D=4, steps=150, restarts=1)
    es3, _, _ = _sweep(gv, D=4, steps=150, restarts=3)
    assert np.all(to_np(es3) <= to_np(es1) + 1e-6)
