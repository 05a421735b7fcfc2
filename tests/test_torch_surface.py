"""The port's package surface: every public top-level name of every
qmps_tpu module and package ``__init__`` (read with ``ast``, so the JAX
package is not imported) exists at the same path in qmps_torch, apart from
an allow-list of TPU-only names, each with its reason (ROADMAP.md section
3 mirrors it).  Also the package-level imports the examples use, and the
small leaves that completed the surface: ``mps.transfer.dominant_eig_power``,
``ham.exact.tfim_gs_energy`` and ``env.variational.env_M_ansatz``."""
import ast
import importlib
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_parity  # noqa: F401  (one torch thread per worker)

REPO = pathlib.Path(__file__).resolve().parents[1]
JAX_PKG = REPO / "qmps_tpu"

#: (module path, name or None for the whole module) -> why the port has no counterpart
ALLOWED = {
    ("config", "Precision"): "the dtype bundle of the TPU hot paths; the port passes torch dtypes "
                             "(config.default_dtypes)",
    ("config", "DEFAULT"): "a Precision instance",
    ("config", "FAST"): "a Precision instance",
    ("config", "on_tpu"): "asks JAX for a TPU backend; the port's device rule is config.resolve_device",
    ("kernels.pallas_power", "LANE"): "the TPU's 128-lane component-plane layout",
    ("kernels.tdvp_fused", "LANE"): "the TPU's 128-lane component-plane layout",
    ("kernels.brickwork_pallas", "LANE"): "the TPU's 128-lane component-plane layout",
    ("kernels.pallas_power", "MAX_COMPONENT_N"): "the TPU component-plane kernel's size limit",
    ("kernels.pallas_power", "dominant_eig_batched_pallas"): "takes the TPU's component-plane layout; the "
                                                             "port's face is dominant_eig_batched",
    ("utils.flops", "MXU_BF16"): "a TPU v5e unit's peak; the H100's are PEAK_F32, PEAK_TF32, HBM_BPS",
    ("utils.flops", "MXU_F32"): "a TPU v5e unit's peak; the H100's are PEAK_F32, PEAK_TF32, HBM_BPS",
    ("utils.flops", "VPU_F32"): "a TPU v5e unit's peak; the H100's are PEAK_F32, PEAK_TF32, HBM_BPS",
    ("utils.profiling", "Throughput"): "a steps/s counter that nothing read; the port's host time per layer "
                                       "is its spans (utils.profiling.span)",
    ("utils.logging", "Timer"): "a wall-clock timer that nothing read; the port's spans time its layers",
    ("utils", "Timer"): "utils.logging.Timer, re-exported; left out with it",
}


def _public_names(path: pathlib.Path) -> set:
    """Top-level public bindings: defs, classes, assignments, and the names a
    package ``__init__`` imports."""
    names = set()
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, ast.Assign):
            for target in node.targets:
                for t in target.elts if isinstance(target, ast.Tuple) else [target]:
                    if isinstance(t, ast.Name):
                        names.add(t.id)
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target, ast.Name):
            names.add(node.target.id)
        elif isinstance(node, ast.ImportFrom) and path.name == "__init__.py" and node.level == 1:
            names.update(a.asname or a.name for a in node.names)
    return {n for n in names if not n.startswith("_")}


def _jax_modules():
    for path in sorted(JAX_PKG.rglob("*.py")):
        rel = path.relative_to(JAX_PKG).with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        yield ".".join(parts), path


def test_every_public_name_has_its_counterpart():
    missing = []
    for mod, path in _jax_modules():
        if (mod, None) in ALLOWED:
            continue
        port = importlib.import_module("qmps_torch" + ("." + mod if mod else ""))
        missing += [(mod, n) for n in sorted(_public_names(path)) if not hasattr(port, n) and (mod, n) not in ALLOWED]
    assert not missing, missing


def test_the_allow_list_names_only_what_is_missing():
    """Each entry names a JAX name that exists and a port name that does not,
    so the list cannot outlive a port."""
    jax_names = {mod: _public_names(path) for mod, path in _jax_modules()}
    for (mod, name), reason in ALLOWED.items():
        assert reason
        assert mod in jax_names and (name is None or name in jax_names[mod]), (mod, name)
        port_mod = "qmps_torch." + mod
        if name is None:
            assert not (REPO / pathlib.Path(*port_mod.split("."))).with_suffix(".py").exists(), mod
        else:
            assert not hasattr(importlib.import_module(port_mod), name), (mod, name)


def test_package_imports_stay_light():
    """``import qmps_torch`` and its package surface build nothing: no CUDA
    library loaded, no native planner built, no JAX."""
    code = (
        "import sys; import qmps_torch, qmps_torch.mps, qmps_torch.kernels, qmps_torch.native; "
        "from qmps_torch.mps import iMPS, vumps_ground_state_cell2; from qmps_torch.ham import tfim; "
        "from qmps_torch.optim import minimize_adam; from qmps_torch.embed import unitary_to_tensor; "
        "from qmps_torch.kernels import _lib; import qmps_torch.native as nat; "
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'qmps_tpu'))]; "
        "assert not bad, bad; assert _lib._lib is None; "
        "assert nat._lib.cache_info().currsize == 0; print('ok')"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True)
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", proc.stdout + proc.stderr


def test_optim_rotosolve_is_the_module_and_the_function():
    """As in the JAX package, the package's ``rotosolve`` is the function,
    shadowing the module, which stays in sys.modules."""
    from qmps_torch.optim import rotosolve

    mod = importlib.import_module("qmps_torch.optim.rotosolve")
    assert rotosolve is mod.rotosolve and hasattr(mod, "double_rotosolve_step")
    x, hist = rotosolve(lambda x: (torch.sin(x - 0.3) ** 2).sum(), torch.tensor([1.0, 2.0], dtype=torch.float64),
                        n_sweeps=2)
    assert float(hist[-1]) < 1e-20


# -- the small leaves -------------------------------------------------------------


def test_dominant_eig_power_matches_jax():
    """Power iteration in operator form on a transfer matrvec, 1e-10."""
    from qmps_tpu.mps.transfer import dominant_eig_power as jax_power, right_matvec as jax_mv
    from qmps_torch.mps.transfer import dominant_eig_power, right_matvec

    rng = np.random.default_rng(11)
    A = _torch_parity.left_canonical(rng, 1, D=3)[0]
    r0 = rng.standard_normal((3, 3)) + 1j * rng.standard_normal((3, 3))
    lam_j, v_j = jax_power(lambda r: jax_mv(jnp.asarray(A), jnp.asarray(A), r), jnp.asarray(r0), iters=120)
    At = torch.from_numpy(A)
    lam, v = dominant_eig_power(lambda r: right_matvec(At, At, r), torch.from_numpy(r0), iters=120)
    assert abs(complex(lam) - complex(lam_j)) < 1e-10
    np.testing.assert_allclose(v.numpy(), np.asarray(v_j), atol=1e-10)
    assert abs(abs(complex(lam)) - 1) < 1e-10


def test_tfim_gs_energy_matches_jax_in_the_callers_type():
    from qmps_tpu.ham.exact import tfim_gs_energy as jax_e
    from qmps_torch.ham import tfim_gs_energy, tfim_gs_energy_f64

    g = np.linspace(0.1, 2.0, 17)
    out = tfim_gs_energy(torch.tensor(g))
    assert out.dtype == torch.float64
    np.testing.assert_allclose(out.numpy(), np.asarray(jax_e(jnp.asarray(g))), atol=1e-12)
    np.testing.assert_allclose(out.numpy(), tfim_gs_energy_f64(g), atol=1e-14)
    assert abs(float(tfim_gs_energy(1.0)) - float(jax_e(1.0))) < 1e-12
    f32 = tfim_gs_energy(torch.tensor(g, dtype=torch.float32))
    assert f32.dtype == torch.float32
    np.testing.assert_allclose(f32.numpy(), tfim_gs_energy_f64(g), atol=2e-6)


def test_env_M_ansatz_is_env_M():
    from qmps_torch.circuits.brickwork import env_M
    from qmps_torch.env import env_M_ansatz

    assert env_M_ansatz is env_M


def test_config_numpy_twins():
    from qmps_torch.config import NP_CDTYPE, NP_RDTYPE

    assert NP_CDTYPE is np.complex128 and NP_RDTYPE is np.float64


@pytest.mark.parametrize("mod", ["mps", "ham", "env", "embed", "objectives", "optim", "kernels", "utils", "core",
                                 "circuits", "algorithms", "parallel", "native"])
def test_package_names_are_the_leaf_modules_objects(mod):
    """Each name a package re-exports is the object its leaf module defines."""
    path = JAX_PKG / mod / "__init__.py"
    port = importlib.import_module("qmps_torch." + mod)
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, ast.ImportFrom) and node.level == 1 and node.module:
            if (f"{mod}.{node.module}", None) in ALLOWED:
                continue
            leaf = importlib.import_module(f"qmps_torch.{mod}.{node.module}")
            for a in node.names:
                if (mod, a.name) in ALLOWED:  # left out of the port, with its reason
                    continue
                assert getattr(port, a.name) is getattr(leaf, a.name), (mod, a.name)
