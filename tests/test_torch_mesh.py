"""qmps_torch's ``parallel/mesh`` and the sharded sweeps on a mesh of 8
``cpu`` entries (the JAX suite's conftest gives it 8 virtual devices):
tests/test_sweep.py's, test_stiefel_sweep.py's and test_scars.py's mesh
tests, ported with their sizes and tolerances (the slow one slow), and the
quench and noise sweeps sharded against unsharded.  Each sharded run is
held to the port's own unsharded run, which the other test files hold to
the JAX package; the fused and Stiefel sweeps' sharded bodies are also
held to the JAX package's sharded programs from the same starts.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import qmps_torch.parallel as tpar
from _torch_parity import to_np
from qmps_torch import workloads
from qmps_torch.algorithms.evolve import batched_noise_sweep, batched_quench_sweep
from qmps_torch.algorithms.scars import quantum_poincare_sweep
from qmps_torch.parallel import make_mesh, phase_diagram_sweep, sweep_ground_states, sweep_ground_states_grown
from qmps_torch.parallel import mesh as tmesh
from qmps_torch.parallel.mesh import Mesh, shard_over_sweep
from qmps_torch.parallel import sweep as tsweep
from qmps_torch.parallel.sweep import sweep_ground_states_fused, sweep_ground_states_stiefel
from qmps_tpu.parallel import make_mesh as jax_make_mesh
from qmps_tpu.parallel import sweep as jsweep
from qmps_tpu.parallel.mesh import shard_over_sweep as jax_shard_over_sweep

MESH = Mesh(("cpu",) * 8)
P0 = np.array([0.31, -0.72, 1.05, 0.4, -0.2, 0.66, 0.13, -0.9, 0.5, 0.27, -0.35, 0.8, 0.05, -0.6, 0.22])


def _f(a, b):
    return a * 2 + b, (a - b).sum(axis=-1)


def test_shard_over_sweep_identity_and_mesh():
    """shard_over_sweep is the identity without a mesh and a pure layout
    change with one (multi-output functions included), as the JAX
    package's shard_map over its 8 virtual devices."""
    assert shard_over_sweep(_f, None) is _f
    a = torch.arange(16.0, dtype=torch.float64).reshape(8, 2)
    b = torch.ones(8, 2, dtype=torch.float64)
    x0, y0 = _f(a, b)
    x1, y1 = shard_over_sweep(_f, MESH)(a, b)
    assert torch.equal(x1, x0) and torch.equal(y1, y0)
    xj, yj = jax.jit(jax_shard_over_sweep(_f, jax_make_mesh()))(jnp.asarray(a.numpy()), jnp.asarray(b.numpy()))
    np.testing.assert_array_equal(to_np(x1), np.asarray(xj))
    np.testing.assert_array_equal(to_np(y1), np.asarray(yj))


def test_shard_over_sweep_blocks_are_contiguous_and_pass_the_rest():
    """Shard i gets rows [i m, (i + 1) m) of every tensor and the other
    arguments as they are; nested tuple outputs are joined on the first
    device."""
    seen = []

    def f(x, scale):
        seen.append((x[:, 0].tolist(), scale))
        return (x * scale, (x[:, :1], [x.sum(-1)]))

    x = torch.arange(32.0).reshape(16, 2)
    out = shard_over_sweep(f, MESH)(x, 3.0)
    assert seen == [([4.0 * i, 4.0 * i + 2], 3.0) for i in range(8)]
    assert torch.equal(out[0], 3 * x) and torch.equal(out[1][0], x[:, :1]) and torch.equal(out[1][1][0], x.sum(-1))
    assert isinstance(out[1][1], list)


def test_shard_over_sweep_rejects_a_batch_that_does_not_divide():
    """A leading axis that does not split into the mesh's shards raises, as
    shard_map's does; so does another axis name."""
    with pytest.raises(ValueError, match="does not divide"):
        shard_over_sweep(_f, MESH)(torch.ones(12, 2), torch.ones(12, 2))
    with pytest.raises(ValueError, match="axis"):
        shard_over_sweep(_f, MESH, axis="points")


def test_a_failing_shard_raises_and_nothing_runs_unsharded():
    """A shard that raises makes the call raise; no shard runs the whole
    batch in its place."""
    sizes = []

    def f(x):
        sizes.append(x.shape[0])
        if x[0, 0] >= 8:
            raise RuntimeError("shard failed")
        return x

    with pytest.raises(RuntimeError, match="shard failed"):
        shard_over_sweep(f, Mesh(("cpu",) * 4))(torch.arange(16.0).reshape(16, 1))
    assert sizes and set(sizes) == {4}


def test_mesh_and_make_mesh():
    """A mesh from any device list, the card twice included; make_mesh
    takes the CUDA devices and raises without one."""
    m = Mesh(("cuda:0", "cuda:0"), axis="sweep")
    assert len(m) == 2 and m.devices == (torch.device("cuda", 0),) * 2 and m.axis == "sweep"
    assert len(MESH) == 8 and MESH.devices == (torch.device("cpu"),) * 8
    with pytest.raises(ValueError):
        Mesh(())
    if torch.cuda.device_count() == 0:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_mesh()
    assert tmesh.shards_on_device() == 1


def test_shards_on_device_counts_the_shards_of_a_device():
    """Inside a sharded call each shard sees how many shards share its
    device (the point-chunk rules' share of its free memory)."""
    got = shard_over_sweep(lambda x: x * 0 + tmesh.shards_on_device(), Mesh(("cpu",) * 4))(torch.zeros(4))
    assert got.tolist() == [4.0] * 4 and tmesh.shards_on_device() == 1


@pytest.mark.slow
def test_sharded_sweep_matches_vmap():
    gs = torch.linspace(0.2, 2.0, 16, dtype=torch.float64)
    es_sharded, _ = sweep_ground_states(gs, D=2, steps=120, mesh=MESH)
    es_local, _ = sweep_ground_states(gs, D=2, steps=120)
    np.testing.assert_allclose(to_np(es_sharded), to_np(es_local), atol=1e-9)


def test_sharded_deep_bw_sweep_matches_vmap():
    gs = torch.linspace(0.5, 1.5, 16, dtype=torch.float64)
    es_sharded, _ = sweep_ground_states(gs, D=4, ansatz="deep_bw", steps=3, mesh=MESH)
    es_local, _ = sweep_ground_states(gs, D=4, ansatz="deep_bw", steps=3)
    np.testing.assert_allclose(to_np(es_sharded), to_np(es_local), atol=1e-9)


def test_sharded_refine_passes_cross_the_shards():
    """The refine passes roll the neighbours over the whole batch, across
    shard edges, and draw the jitter on it: sharded equals unsharded
    (D = 2, 2 restarts, one pass; 1e-9)."""
    gs = torch.linspace(0.2, 2.0, 16, dtype=torch.float64)
    kw = dict(D=2, steps=20, restarts=2, refine_passes=1)
    es_s, ps_s = sweep_ground_states(gs, mesh=MESH, generator=torch.Generator().manual_seed(3), **kw)
    es_l, ps_l = sweep_ground_states(gs, generator=torch.Generator().manual_seed(3), **kw)
    np.testing.assert_allclose(to_np(es_s), to_np(es_l), atol=1e-9)
    np.testing.assert_allclose(to_np(ps_s), to_np(ps_l), atol=1e-9)


def test_sharded_grown_and_phase_diagram_sweeps_match():
    """The grown sweep (every rung sharded) and phase_diagram_sweep with a
    mesh against the same calls without one, 1e-9."""
    gs = torch.linspace(0.5, 1.5, 8, dtype=torch.float64)
    es_s, _ = sweep_ground_states_grown(gs, D=4, steps=4, stage_steps=3, mesh=MESH)
    es_l, _ = sweep_ground_states_grown(gs, D=4, steps=4, stage_steps=3)
    np.testing.assert_allclose(to_np(es_s), to_np(es_l), atol=1e-9)
    t_s = phase_diagram_sweep(gs, Ds=(2,), steps=10, mesh=MESH)
    t_l = phase_diagram_sweep(gs, Ds=(2,), steps=10)
    np.testing.assert_allclose(to_np(t_s), to_np(t_l), atol=1e-9)


def test_fused_sweep_sharded_matches_unsharded():
    gs = torch.linspace(0.5, 1.5, 8, dtype=torch.float64)
    kw = dict(steps=20, restarts=2)
    e1, A1 = sweep_ground_states_fused(gs, **kw)
    e2, A2 = sweep_ground_states_fused(gs, mesh=MESH, **kw)
    np.testing.assert_allclose(to_np(e1), to_np(e2), atol=1e-12)
    np.testing.assert_allclose(to_np(A1), to_np(A2), atol=1e-12)


def test_stiefel_sweep_sharded_matches_local():
    gv = torch.linspace(0.4, 1.6, 16, dtype=torch.float64)
    es_l, _, _ = sweep_ground_states_stiefel(gv, D=4, steps=80)
    es_s, _, _ = sweep_ground_states_stiefel(gv, D=4, steps=80, mesh=MESH)
    np.testing.assert_allclose(to_np(es_s), to_np(es_l), atol=1e-9)


def test_fused_sweep_sharded_matches_jax_sharded():
    """The fused sweep's body sharded over 8 cpu entries against the JAX
    package's programs sharded over its 8 virtual devices, from the same
    numpy normals (8 points x 2 restarts, 20 steps; JAX's XLA engine, as
    its mesh test): energies and As to 1e-9, as the unsharded parity test."""
    rng = np.random.default_rng(7)
    gs = np.linspace(0.5, 1.5, 8)
    xre, xim = rng.standard_normal((2, 16, 4, 2))
    j_init, j_make_advance, j_finish = jsweep._fused_sweep_programs(
        0.1, 0.9, 2, 48, False, jnp.float64, engine="xla", mesh=jax_make_mesh())
    hs, V, M = j_init(*(jnp.asarray(x) for x in (gs, xre, xim)))
    V, M = j_make_advance(20)(V, M, hs)
    e_j, A_j = j_finish(V, hs)
    e_t, A_t = tsweep._fused_sweep_from(*(torch.from_numpy(x) for x in (gs, xre, xim)), 20, 0.1, 0.9, 2, 48,
                                        mesh=MESH)
    np.testing.assert_allclose(to_np(e_t), np.asarray(e_j), atol=1e-9)
    np.testing.assert_allclose(to_np(A_t), np.asarray(A_j), atol=1e-9)


def test_stiefel_sweep_sharded_matches_jax_sharded():
    """The Stiefel sweep's body sharded over 8 cpu entries against the JAX
    package's programs sharded over its 8 virtual devices, from the same
    numpy normals (D = 4, 8 points x 2 restarts, 80 steps): energies, As
    and environments to 1e-9 (test_stiefel_sweep.py's mesh tolerance).
    The port's readout projects the carried environment onto the dominant
    eigenspace before JAX's 200 matvecs (``sweep._dominant_environment``):
    the same fixed point here, where the matvecs converge."""
    D, R, n, steps = 4, 2, 8, 80
    rng = np.random.default_rng(5)
    gs = np.linspace(0.4, 1.6, n)
    xre, xim = rng.standard_normal((2, n, R, 2 * D, D))
    j_init, j_make_advance, j_finish = jsweep._stiefel_sweep_programs(D, 0.08, 0.9, R, 24, 200, jnp.float64,
                                                                      jax_make_mesh())
    hs, V, M, r = j_init(jnp.asarray(gs), *(jnp.asarray(x.reshape(n * R, 2 * D, D)) for x in (xre, xim)), None)
    V, M, r = j_make_advance(steps)(V, M, r, hs)
    out_j = j_finish(V, r, hs)
    out_t = tsweep._stiefel_sweep_from(*(torch.from_numpy(x) for x in (gs, xre, xim)), None, D, steps, 0.08, 0.9,
                                       R, 24, 200, mesh=MESH)
    for a, b in zip(out_t, out_j):
        np.testing.assert_allclose(to_np(a), np.asarray(b), atol=1e-9)


def _pin():
    return torch.get_float32_matmul_precision(), torch.backends.cuda.matmul.allow_tf32


def test_matmul_tier_default_raises_inside_a_shard():
    """The float32 matmul precision is process-wide: the "default" tier
    raises inside a shard (here the CPU's, which run in the caller's thread,
    in turn), the full-float32 tiers do not, and outside a shard "default"
    is entered as before and restores the pin."""
    seen = []

    def f(x):
        seen.append(tmesh.in_shard())
        for tier in (None, "highest", "high"):
            with tsweep._matmul_tier(tier):
                pass
        with pytest.raises(RuntimeError, match="inside a shard"), tsweep._matmul_tier("default"):
            pass
        return x

    assert not tmesh.in_shard() and _pin() == ("highest", False)
    shard_over_sweep(f, Mesh(("cpu",) * 2))(torch.zeros(2))
    assert seen == [True, True] and not tmesh.in_shard() and _pin() == ("highest", False)
    with tsweep._matmul_tier("default"):
        assert _pin() == ("high", True)
    assert _pin() == ("highest", False)


def test_stiefel_default_tier_sharded_equals_unsharded_and_leaves_the_pin(monkeypatch):
    """The Stiefel sweep at the "default" tier with a polish tail, sharded
    over two cpu entries: every shard's first steps run under the tier,
    which the caller sets once, and every shard's polish steps at full
    float32 (the tier each step's polar retraction sees, recorded); the
    full-float32 pin is back afterwards, and the result equals the
    unsharded run to 1e-9."""
    gv = torch.linspace(0.4, 1.6, 8, dtype=torch.float64)
    kw = dict(D=4, steps=40, precision="default", polish_steps=15)
    polar, tiers = tsweep._polar_ns, []
    monkeypatch.setattr(tsweep, "_polar_ns",
                        lambda W, iters=10: tiers.append(torch.get_float32_matmul_precision()) or polar(W, iters))
    out_l = sweep_ground_states_stiefel(gv, **kw)
    assert tiers == ["high"] * 25 + ["highest"] * 15 and _pin() == ("highest", False)
    tiers.clear()
    out_s = sweep_ground_states_stiefel(gv, mesh=Mesh(("cpu",) * 2), **kw)
    assert tiers == ["high"] * 2 * 25 + ["highest"] * 2 * 15 and _pin() == ("highest", False)
    for a, b in zip(out_s, out_l):
        np.testing.assert_allclose(to_np(a), to_np(b), atol=1e-9)


def test_stiefel_two_phase_sharded_matches_jax_sharded():
    """The two-phase schedule sharded over 8 cpu entries against the JAX
    package's programs on its 8 virtual devices from the same numpy
    normals: make_advance(steps - polish, "default"), then
    make_advance(polish), then finish (D = 4, 8 points x 2 restarts, 60
    steps, 20 of them polish): energies, As and environments to 1e-9.
    The readout departs from JAX's as in
    ``test_stiefel_sweep_sharded_matches_jax_sharded``."""
    D, R, n, steps, polish = 4, 2, 8, 60, 20
    rng = np.random.default_rng(6)
    gs = np.linspace(0.4, 1.6, n)
    xre, xim = rng.standard_normal((2, n, R, 2 * D, D))
    j_init, j_make_advance, j_finish = jsweep._stiefel_sweep_programs(D, 0.08, 0.9, R, 24, 200, jnp.float64,
                                                                      jax_make_mesh())
    hs, V, M, r = j_init(jnp.asarray(gs), *(jnp.asarray(x.reshape(n * R, 2 * D, D)) for x in (xre, xim)), None)
    V, M, r = j_make_advance(steps - polish, "default")(V, M, r, hs)
    V, M, r = j_make_advance(polish)(V, M, r, hs)
    out_j = j_finish(V, r, hs)
    out_t = tsweep._stiefel_sweep_from(*(torch.from_numpy(x) for x in (gs, xre, xim)), None, D, steps, 0.08, 0.9,
                                       R, 24, 200, mesh=MESH, precision="default", polish=polish)
    assert _pin() == ("highest", False)
    for a, b in zip(out_t, out_j):
        np.testing.assert_allclose(to_np(a), np.asarray(b), atol=1e-9)


def test_quantum_poincare_sweep_sharded_matches_vmap():
    rng = np.random.default_rng(0)
    y0s = torch.from_numpy(rng.uniform(0.5, 1.5, (8, 4)))
    t_v = quantum_poincare_sweep(y0s, 0.4, 0.05, 3, inner_steps=10)
    t_s = quantum_poincare_sweep(y0s, 0.4, 0.05, 3, inner_steps=10, mesh=MESH)
    np.testing.assert_allclose(to_np(t_s), to_np(t_v), atol=1e-10)


@pytest.mark.parametrize("engine", ["dense", "pallas"])
def test_quench_sweep_sharded_matches_unsharded(engine):
    """Eight quench trajectories, one a shard, against the same batch
    unsharded: 1e-10 (3 outer steps of 10 inner)."""
    g1s = torch.linspace(0.1, 0.4, 8, dtype=torch.float64)
    kw = dict(t_max=0.06, n_steps=3, inner_steps=10, params0=torch.from_numpy(P0), engine=engine)
    t_l, les_l = batched_quench_sweep(1.5, g1s, **kw)
    t_s, les_s = batched_quench_sweep(1.5, g1s, mesh=MESH, **kw)
    assert torch.equal(t_s, t_l) and les_s.shape == (8, 3)
    np.testing.assert_allclose(to_np(les_s), to_np(les_l), atol=1e-10)


def test_noise_sweep_sharded_matches_unsharded():
    """Eight noise levels split over four shards against one batch: 1e-10
    (the same ground state, 2 outer steps of 5 inner)."""
    levels = torch.tensor([0.0, 1e-4, 3e-4, 1e-3, 3e-3, 1e-2, 2e-2, 3e-2], dtype=torch.float64)
    kw = dict(inner_steps=5, gs_steps=30)
    _, r_l = batched_noise_sweep(1.5, 0.2, 0.04, 2, levels, generator=torch.Generator().manual_seed(1), **kw)
    _, r_s = batched_noise_sweep(1.5, 0.2, 0.04, 2, levels, generator=torch.Generator().manual_seed(1),
                                 mesh=Mesh(("cpu",) * 4), **kw)
    assert r_s.shape == (8, 2) and torch.isfinite(r_s).all()
    np.testing.assert_allclose(to_np(r_s), to_np(r_l), atol=1e-10)


def test_sweep_config_use_mesh(monkeypatch):
    """SweepConfig(use_mesh=True) shards over every card when there is
    more than one (here 8 entries stand in for them), and runs unsharded
    on one card or none, with the same energies."""
    cfg = dict(n_points=8, steps=5, device="cpu")
    gs = workloads.SweepConfig(**cfg).grid()
    es_plain, _ = workloads.SweepConfig(**cfg).sweep(gs)
    es_none, _ = workloads.SweepConfig(use_mesh=True, **cfg).sweep(gs)  # no card: no mesh
    meshes = []
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 8)
    monkeypatch.setattr(tpar, "make_mesh", lambda: meshes.append(MESH) or MESH)
    es_mesh, _ = workloads.SweepConfig(use_mesh=True, **cfg).sweep(gs)
    assert meshes == [MESH]
    np.testing.assert_allclose(to_np(es_none), to_np(es_plain), atol=0)
    np.testing.assert_allclose(to_np(es_mesh), to_np(es_plain), atol=1e-9)


def test_every_jax_entry_point_with_a_mesh_takes_one():
    """Every public function of the JAX package with a ``mesh`` parameter
    (read with ast) has one at the same path in the port."""
    import ast
    import importlib
    import inspect
    import pathlib

    root = pathlib.Path(jax_make_mesh.__code__.co_filename).parents[1]
    found = []
    for path in sorted(root.rglob("*.py")):
        for node in ast.parse(path.read_text()).body:
            if (isinstance(node, ast.FunctionDef) and not node.name.startswith("_")
                    and "mesh" in [a.arg for a in node.args.args + node.args.kwonlyargs]):
                mod = ".".join(path.relative_to(root).with_suffix("").parts)
                found.append(f"{mod}.{node.name}")
                port = getattr(importlib.import_module(f"qmps_torch.{mod}"), node.name)
                assert "mesh" in inspect.signature(port).parameters, found[-1]
    assert sorted(found) == [
        "algorithms.evolve.batched_noise_sweep", "algorithms.evolve.batched_quench_sweep",
        "algorithms.scars.quantum_poincare_sweep", "parallel.mesh.shard_over_sweep",
        "parallel.sweep.phase_diagram_sweep", "parallel.sweep.sweep_ground_states",
        "parallel.sweep.sweep_ground_states_fused", "parallel.sweep.sweep_ground_states_grown",
        "parallel.sweep.sweep_ground_states_stiefel"], found
