"""qmps_torch.parallel.sweep against qmps_tpu.parallel.sweep: the same
numpy normals through both packages' init / advance / finish, the port's
own convergence to the exact TFIM energy, and the port's independence of
JAX.  Mirrors tests/test_sweep.py:141-176.
"""
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import torch

from _torch_parity import to_np
from qmps_torch.ham.exact import tfim_gs_energy_f64
from qmps_torch.parallel import sweep as tsweep
from qmps_torch.utils.convert import from_numpy
from qmps_tpu.parallel import sweep as jsweep

REPO = Path(__file__).resolve().parent.parent


def test_tfim_matrix_matches_jax():
    g = np.array([0.1, 1.0, 1.7])
    h_j = np.asarray(jsweep.tfim_matrix(jnp.asarray(g)[:, None, None]))
    h_t = tsweep.tfim_matrix(from_numpy(g))
    np.testing.assert_allclose(to_np(h_t), h_j.real, atol=1e-15)


def test_programs_match_jax_from_the_same_normals():
    """8 points x 2 restarts x 20 steps, complex128: V, M, energies and
    returned As agree to 1e-9; the As are left-canonical."""
    rng = np.random.default_rng(7)
    gs = np.linspace(0.5, 1.5, 8)
    xre, xim = rng.standard_normal((2, 16, 4, 2))
    j_init, j_make_advance, j_finish = jsweep._fused_sweep_programs(
        0.1, 0.9, 2, 48, False, jnp.float64, engine="xla"
    )
    t_init, t_advance, t_finish = tsweep._fused_sweep_programs(0.1, 0.9, 2, 48)

    hs_j, V_j, M_j = j_init(jnp.asarray(gs), jnp.asarray(xre), jnp.asarray(xim))
    hs_t, V_t, M_t = t_init(*(from_numpy(x) for x in (gs, xre, xim)))
    np.testing.assert_allclose(to_np(hs_t), np.asarray(hs_j), atol=1e-15)
    np.testing.assert_allclose(to_np(V_t), np.asarray(V_j), atol=1e-12)

    V_j, M_j = j_make_advance(20)(V_j, M_j, hs_j)
    V_t, M_t = t_advance(V_t, M_t, hs_t, 20)
    np.testing.assert_allclose(to_np(V_t), np.asarray(V_j), atol=1e-9)
    np.testing.assert_allclose(to_np(M_t), np.asarray(M_j), atol=1e-9)

    e_j, A_j = j_finish(V_j, hs_j)
    e_t, A_t = t_finish(V_t, hs_t)
    np.testing.assert_allclose(to_np(e_t), np.asarray(e_j), atol=1e-9)
    np.testing.assert_allclose(to_np(A_t), np.asarray(A_j), atol=1e-9)
    A = to_np(A_t)
    lc = np.einsum("bsik,bsij->bkj", A.conj(), A)
    np.testing.assert_allclose(lc, np.broadcast_to(np.eye(2), lc.shape), atol=1e-10)


def test_port_converges_to_exact():
    """The port's own sweep (complex128, plain objective) lands on the
    exact TFIM integral: 12 points x 220 steps x 2 restarts, the bounds of
    test_sweep.py:174-176 (variational, median 5e-4, max 5e-3)."""
    gs = np.linspace(0.3, 1.8, 12)
    es, As = tsweep.sweep_ground_states_fused(
        torch.from_numpy(gs), steps=220, restarts=2, generator=torch.Generator().manual_seed(1)
    )
    assert es.shape == (12,) and As.shape == (12, 2, 2, 2) and es.dtype == torch.float64
    err = to_np(es) - tfim_gs_energy_f64(gs)
    assert np.all(err > -1e-9), err
    assert np.median(err) < 5e-4, err
    assert np.max(err) < 5e-3, err


def test_port_never_imports_jax():
    """Importing every module of qmps_torch that pkgutil.walk_packages
    finds, the examples among them, leaves jax out of sys.modules."""
    code = (
        "import importlib, pkgutil, sys; import qmps_torch; "
        "mods = [m.name for m in pkgutil.walk_packages(qmps_torch.__path__, 'qmps_torch.')]; "
        "[importlib.import_module(m) for m in mods]; "
        "assert 'qmps_torch.examples.scars_poincare' in mods and 'qmps_torch.native' in mods, mods; "
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'qmps_tpu'))]; "
        "print(len(mods), bad); sys.exit(1 if bad else 0)"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True)
    assert proc.returncode == 0, proc.stdout + proc.stderr
