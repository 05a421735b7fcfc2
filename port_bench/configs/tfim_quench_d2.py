"""Job driver of ``tfim_quench_d2``: one job is one quench family,
``qmps_torch.algorithms.evolve.batched_quench_sweep(engine="pallas")`` of
the cell's ``trajectories`` couplings g1 from the ground state of g0 found
in set-up, and its overlap densities copied to the host.

The comparison reads every trajectory of every job (``reference``):
- ``rate_err_first``: the largest gap between a returned rate, -log of
  the overlap density, and the exact Loschmidt rate at the first outer
  step, where the D = 2 method's own error is least (under 1e-5), so the
  gap reads the numerics of K4/K5, adam and the readout;
  its limit is the cell's, set from readings of the program and of the
  control;
- ``rate_err_max``: the same over every outer step, where the method's
  error grows with t (to ~2e-3 at t = 0.2), against the configuration's
  stated bar;
- ``start_gap``: the float64 energy of the set-up's ground state above the
  exact energy, against the configuration's stated bar;
- ``answers_missing``: trajectory steps not returned, or not finite.
"""
from __future__ import annotations

import numpy as np
import torch

from port_bench import reference as ref
from port_bench.harness import check_entry


def _stream(seed: int, *labels: int) -> np.random.SeedSequence:
    return np.random.SeedSequence([seed % 2 ** 64, *labels])


def _couplings(cfg: dict, cell: dict, ss: np.random.SeedSequence) -> np.ndarray:
    return np.sort(np.random.default_rng(ss).uniform(cfg["g1_min"], cfg["g1_max"], cell["trajectories"]))


def job_inputs(cfg: dict, cell: dict, seed: int, index: int) -> dict:
    """Job ``index``'s couplings g1 (label 1; 0 is the warm-up's, 2 the
    ground state's starts)."""
    return {"g1": _couplings(cfg, cell, _stream(seed, 1, index))}


def work(cfg: dict, cell: dict) -> float:
    """Trajectory steps a job completes: trajectories x outer steps."""
    return cell["trajectories"] * cfg["n_steps"]


def steps(cfg: dict, cell: dict) -> int:
    """Inner (adam) steps a job takes."""
    return cfg["n_steps"] * cfg["inner_steps"]


def kernel_batch(cfg: dict, cell: dict) -> int:
    """Elements of each K4/K5 launch: the family's trajectories."""
    return cell["trajectories"]


def _starts(cfg: dict, seed: int) -> list:
    """The ground state's start seeds, one CPU generator each."""
    return [int(s) for s in _stream(seed, 2).generate_state(cfg["gs_starts"], np.uint64)]


def _quench(state: dict, g1: np.ndarray, n_steps: int, inner_steps: int) -> np.ndarray:
    from qmps_torch.algorithms.evolve import batched_quench_sweep

    cfg = state["cfg"]
    _, les = batched_quench_sweep(
        cfg["g0"], g1, t_max=cfg["dt"] * n_steps, n_steps=n_steps, inner_steps=inner_steps, lr=cfg["lr"],
        params0=state["params0"], engine="pallas", pallas_iters=cfg["pallas_iters"], device=state["device"])
    return les.cpu().numpy()


def setup(cfg: dict, cell: dict, seed: int, device) -> dict:
    """The initial ground state (the lowest of ``gs_starts`` L-BFGS runs by
    the program's own energy), then the cell's shapes warmed by one outer
    step of two inner steps over the cell's own batch."""
    from qmps_torch.algorithms.ground_state import find_ground_state
    from qmps_torch.ham.hamiltonian import tfim

    best = None
    for s in _starts(cfg, seed):
        res = find_ground_state(tfim(cfg["g0"]), D=2, ansatz=cfg["ansatz"], method=cfg["gs_method"],
                                steps=cfg["gs_steps"], generator=torch.Generator().manual_seed(s), device=device)
        if best is None or float(res.energy) < float(best.energy):
            best = res
    state = {"cfg": cfg, "device": device, "params0": best.params.detach()}
    state["params0_host"] = state["params0"].double().cpu().numpy()
    _quench(state, _couplings(cfg, cell, _stream(seed, 0)), 1, 2)
    return state


def run_job(state: dict, inputs: dict) -> dict:
    cfg = state["cfg"]
    return {"le": _quench(state, inputs["g1"], cfg["n_steps"], cfg["inner_steps"])}


def control_setup(cfg: dict, cell: dict, seed: int, device) -> dict:
    """The reference's own initial state: the lowest of its L-BFGS runs
    (float64, on the CPU) from the same starts as the program's."""
    best, best_e = None, np.inf
    for s in _starts(cfg, seed):
        x0 = torch.randn(15, generator=torch.Generator().manual_seed(s), dtype=torch.float64) * 0.5
        p = ref.ground_state_plain(cfg["g0"], x0.numpy(), cfg["gs_steps"])
        e = float(ref.mps_energy_f64(ref.full15_tensor_f64(p[None]), [cfg["g0"]])[0])
        if e < best_e:
            best, best_e = p, e
    return {"cfg": cfg, "device": device, "params0_host": best}


def control_job(state: dict, inputs: dict, prec: str) -> dict:
    """The reference in the program's place: the plain quench at ``prec``."""
    cfg = state["cfg"]
    return {"le": ref.quench_plain(state["params0_host"], inputs["g1"], cfg["dt"] * cfg["n_steps"], cfg["n_steps"],
                                   cfg["inner_steps"], cfg["lr"], cfg["pallas_iters"], prec, state["device"])}


def answered(cfg: dict, cell: dict, outputs: dict) -> bool:
    le = outputs.get("le")
    return le is not None and le.shape == (cell["trajectories"], cfg["n_steps"]) and bool(np.isfinite(le).all())


def check(cfg: dict, cell: dict, state: dict, jobs: list) -> dict:
    """The compared numbers over every trajectory step of every job."""
    ok_jobs = [j for j in jobs if answered(cfg, cell, j.outputs)]
    missing = cell["trajectories"] * cfg["n_steps"] * (len(jobs) - len(ok_jobs))
    t = cfg["dt"] * np.arange(1, cfg["n_steps"] + 1)
    err = first = 0.0 if ok_jobs else float("inf")
    for j in ok_jobs:
        exact = np.stack([ref.loschmidt_rate_exact(t, cfg["g0"], g1) for g1 in j.inputs["g1"]])
        with np.errstate(divide="ignore", invalid="ignore"):
            gap = np.abs(-np.log(j.outputs["le"].astype(np.float64)) - exact)
        err, first = max(err, float(np.max(gap))), max(first, float(np.max(gap[:, 0])))
    A0 = ref.full15_tensor_f64(np.asarray(state["params0_host"])[None])
    start_gap = float(ref.mps_energy_f64(A0, [cfg["g0"]])[0] - ref.tfim_energy_exact(cfg["g0"]))
    return {
        "rate_err_first": check_entry(first, cell["limits"]["rate_err_first"]),
        "rate_err_max": check_entry(err, cfg["accuracy"]["rate_err_max"]),
        "start_gap": check_entry(start_gap, cfg["accuracy"]["start_gap"]),
        "answers_missing": check_entry(missing, 0),
    }
