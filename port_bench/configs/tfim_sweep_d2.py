"""Job driver of ``tfim_sweep_d2``: one job is one D = 2 TFIM phase-diagram
sweep, ``qmps_torch.parallel.sweep_ground_states_fused`` over the cell's
``points`` couplings with the configuration's steps and restarts, and its
energies and tensors copied to the host.

The comparison reads every point of every job in float64 (``reference``):
- ``energy_err_max``: the largest gap between a returned energy (K2 on the
  final state) and the float64 energy of the returned tensor; its limit is
  the cell's, set from readings of the program and of the control;
- ``gap_median``, ``gap_max``: the returned tensors' float64 energies above
  the exact energy (the descent, K3), the worst job's median and the
  largest, against the configuration's stated bars;
- ``answers_missing``: points not returned, or not finite.
"""
from __future__ import annotations

import numpy as np
import torch

from port_bench import reference as ref
from port_bench.harness import check_entry


def _stream(seed: int, *labels: int) -> np.random.SeedSequence:
    return np.random.SeedSequence([seed % 2 ** 64, *labels])


def job_inputs(cfg: dict, cell: dict, seed: int, index: int) -> dict:
    """Job ``index``'s couplings (sorted, uniform in [g_min, g_max]) and the
    seed of its start normals; label 0 is the warm-up's, 1 the jobs'."""
    ss = _stream(seed, 1, index)
    g = np.sort(np.random.default_rng(ss).uniform(cfg["g_min"], cfg["g_max"], cell["points"]))
    return {"g": g, "start_seed": int(ss.spawn(1)[0].generate_state(1, np.uint64)[0])}


def work(cfg: dict, cell: dict) -> float:
    """Ground-state points a job completes."""
    return cell["points"]


def steps(cfg: dict, cell: dict) -> int:
    """Driver steps a job takes."""
    return cfg["steps"]


def kernel_batch(cfg: dict, cell: dict) -> int:
    """Elements of each K2/K3 launch: every point's every restart."""
    return cell["points"] * cfg["restarts"]


def _sweep(state: dict, inputs: dict, n_steps: int) -> dict:
    from qmps_torch.parallel import sweep_ground_states_fused

    cfg = state["cfg"]
    es, As = sweep_ground_states_fused(
        inputs["g"], steps=n_steps, lr=cfg["lr"], momentum=cfg["momentum"], restarts=cfg["restarts"],
        generator=torch.Generator().manual_seed(inputs["start_seed"]), iters=cfg["iters"],
        device=state["device"])
    return {"energies": es.cpu().numpy(), "As": As.cpu().numpy()}


def setup(cfg: dict, cell: dict, seed: int, device) -> dict:
    """Load the kernels and warm the cell's shapes with a two-step sweep of
    the cell's own batch."""
    state = {"cfg": cfg, "device": device}
    ss = _stream(seed, 0)
    warm = {"g": np.sort(np.random.default_rng(ss).uniform(cfg["g_min"], cfg["g_max"], cell["points"])),
            "start_seed": int(ss.generate_state(1, np.uint64)[0])}
    _sweep(state, warm, 2)
    return state


def run_job(state: dict, inputs: dict) -> dict:
    return _sweep(state, inputs, state["cfg"]["steps"])


def control_setup(cfg: dict, cell: dict, seed: int, device) -> dict:
    return {"cfg": cfg, "device": device}


def control_job(state: dict, inputs: dict, prec: str) -> dict:
    """The reference in the program's place: the plain sweep at ``prec``
    from the same couplings and the same start normals."""
    cfg = state["cfg"]
    n = inputs["g"].shape[0] * cfg["restarts"]
    gen = torch.Generator().manual_seed(inputs["start_seed"])
    xre = torch.randn((n, 4, 2), generator=gen, dtype=torch.float64)
    xim = torch.randn((n, 4, 2), generator=gen, dtype=torch.float64)
    es, As = ref.sweep_plain(inputs["g"], xre, xim, cfg["steps"], cfg["lr"], cfg["momentum"], cfg["restarts"],
                             cfg["iters"], prec, state["device"])
    return {"energies": es, "As": As}


def answered(cfg: dict, cell: dict, outputs: dict) -> bool:
    e, A = outputs.get("energies"), outputs.get("As")
    return (e is not None and A is not None and e.shape == (cell["points"],)
            and A.shape == (cell["points"], 2, 2, 2) and bool(np.isfinite(e).all() and np.isfinite(A).all()))


def check(cfg: dict, cell: dict, state: dict, jobs: list) -> dict:
    """The compared numbers over every point of every job."""
    ok_jobs = [j for j in jobs if answered(cfg, cell, j.outputs)]
    missing = cell["points"] * (len(jobs) - len(ok_jobs))
    err = median = gap_max = 0.0 if ok_jobs else float("inf")
    for j in ok_jobs:
        g = j.inputs["g"]
        e64 = ref.mps_energy_f64(j.outputs["As"], g)
        gap = e64 - ref.tfim_energy_exact(g)
        err = max(err, float(np.max(np.abs(j.outputs["energies"].astype(np.float64) - e64))))
        median, gap_max = max(median, float(np.median(gap))), max(gap_max, float(np.max(gap)))
    return {
        "energy_err_max": check_entry(err, cell["limits"]["energy_err_max"]),
        "gap_median": check_entry(median, cfg["accuracy"]["gap_median"]),
        "gap_max": check_entry(gap_max, cfg["accuracy"]["gap_max"]),
        "answers_missing": check_entry(missing, 0),
    }
