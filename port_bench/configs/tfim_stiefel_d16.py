"""Job driver of ``tfim_stiefel_d16``: one job is one D = 16 TFIM
phase-diagram sweep, ``sweep_ground_states_stiefel`` over the cell's
``points`` couplings with the configuration's steps, restarts and
environment iterations, and its energies and tensors copied to the host.

The comparison reads every point of every job in float64
(``reference_stiefel.mps_energy_f64_general``, on the run's device):
- ``energy_err_max``: the largest gap between a returned energy (the
  sweep's readout: its recycled environment projected onto the transfer
  matrix's dominant eigenspace, then ``final_iters`` matvecs) and the
  float64 energy of the returned tensor; its limit is the cell's, set from
  readings of the program and of the control;
- ``gap_median``: the returned tensors' float64 energies above the exact
  energy, the worst job's median, against the cell's limit, set from
  readings below the configuration's stated bar: it reads the descent, so
  a descent at a lower precision fails it;
- ``gap_max``: the largest such gap, against the stated bar;
- ``below_exact``: the largest amount by which a returned tensor's float64
  energy lies below the exact energy (negative: every one lies above by at
  least that much); no uniform MPS lies below it, so this guards the
  float64 readout itself;
- ``answers_missing``: points not returned, or not finite.
"""
from __future__ import annotations

import numpy as np
import torch

from port_bench import reference as ref
from port_bench import reference_stiefel as refs
from port_bench.harness import check_entry


def _stream(seed: int, *labels: int) -> np.random.SeedSequence:
    return np.random.SeedSequence([seed % 2 ** 64, *labels])


def _draw(cfg: dict, points: int, ss: np.random.SeedSequence) -> dict:
    g = np.sort(np.random.default_rng(ss).uniform(cfg["g_min"], cfg["g_max"], points))
    return {"g": g, "start_seed": int(ss.spawn(1)[0].generate_state(1, np.uint64)[0])}


def job_inputs(cfg: dict, cell: dict, seed: int, index: int) -> dict:
    """Job ``index``'s couplings (sorted, uniform in [g_min, g_max]) and the
    seed of its starts; label 0 is the warm-up's, 1 the jobs'."""
    return _draw(cfg, cell["points"], _stream(seed, 1, index))


def work(cfg: dict, cell: dict) -> float:
    """Ground-state points a job completes."""
    return cell["points"]


def steps(cfg: dict, cell: dict) -> int:
    """Driver steps a job takes."""
    return cfg["steps"]


def kernel_batch(cfg: dict, cell: dict) -> int:
    """Rows of each batched product: every point's every restart."""
    return cell["points"] * cfg["restarts"]


def start_normals(start_seed: int, points: int, restarts: int, D: int) -> tuple:
    """(re, im) float64 start normals (points restarts, 2D, D), row p *
    restarts + k point p's restart k, as the entry point draws them from a
    CPU ``torch.Generator`` seeded with ``start_seed``: one seed from the
    generator, then each restart slot's normals from a generator of its
    own, seeded by (seed, branch, slot) through a NumPy SeedSequence (the
    entry point's documented nesting of restart slots)."""
    seed = int(torch.randint(0, 2 ** 62, (1,), generator=torch.Generator().manual_seed(start_seed)))

    def draw(branch, slot):
        s = int(np.random.SeedSequence([seed, branch, slot]).generate_state(1, np.uint64)[0])
        return torch.randn((points, 2 * D, D), generator=torch.Generator().manual_seed(s), dtype=torch.float64)

    return tuple(torch.stack([draw(b, k) for k in range(restarts)], 1).reshape(points * restarts, 2 * D, D)
                 for b in (0, 1))


def _sweep(state: dict, inputs: dict, n_steps: int, precision: str | None = None) -> dict:
    from qmps_torch.parallel import sweep_ground_states_stiefel

    cfg = state["cfg"]
    es, As, _ = sweep_ground_states_stiefel(
        inputs["g"], D=cfg["D"], steps=n_steps, lr=cfg["lr"], momentum=cfg["momentum"], restarts=cfg["restarts"],
        generator=torch.Generator().manual_seed(inputs["start_seed"]), recycle_iters=cfg["recycle_iters"],
        final_iters=cfg["final_iters"], point_chunk=cfg["point_chunk"], precision=precision or cfg["precision"],
        polish_steps=cfg["polish_steps"], device=state["device"])
    return {"energies": es.cpu().numpy(), "As": As.cpu().numpy()}


def setup(cfg: dict, cell: dict, seed: int, device) -> dict:
    """Warm the cell's shapes with a two-step sweep of the cell's own batch."""
    state = {"cfg": cfg, "device": device}
    _sweep(state, _draw(cfg, cell["points"], _stream(seed, 0)), 2)
    return state


def run_job(state: dict, inputs: dict) -> dict:
    return _sweep(state, inputs, state["cfg"]["steps"])


def control_setup(cfg: dict, cell: dict, seed: int, device) -> dict:
    return {"cfg": cfg, "device": device}


#: the control ``prec`` that runs the program itself at its lower tier
PROGRAM_DEFAULT = "program_default"


def control_job(state: dict, inputs: dict, prec: str) -> dict:
    """The reference in the program's place: the plain sweep at ``prec``
    from the same couplings and the same start normals.  ``prec``
    ``PROGRAM_DEFAULT`` runs the program itself at its "default" tier
    (every step in one-pass TF32 on the card, the readout at full
    float32): the lower precision a faster descent could take."""
    cfg = state["cfg"]
    if prec == PROGRAM_DEFAULT:
        return _sweep(state, inputs, cfg["steps"], "default")
    xre, xim = start_normals(inputs["start_seed"], inputs["g"].shape[0], cfg["restarts"], cfg["D"])
    es, As = refs.stiefel_sweep_plain(inputs["g"], xre, xim, cfg["D"], cfg["steps"], cfg["lr"], cfg["momentum"],
                                      cfg["restarts"], cfg["recycle_iters"], cfg["final_iters"], prec,
                                      state["device"])
    return {"energies": es, "As": As}


def answered(cfg: dict, cell: dict, outputs: dict) -> bool:
    e, A = outputs.get("energies"), outputs.get("As")
    D = cfg["D"]
    return (e is not None and A is not None and e.shape == (cell["points"],)
            and A.shape == (cell["points"], 2, D, D) and bool(np.isfinite(e).all() and np.isfinite(A).all()))


def check(cfg: dict, cell: dict, state: dict, jobs: list) -> dict:
    """The compared numbers over every point of every job."""
    ok_jobs = [j for j in jobs if answered(cfg, cell, j.outputs)]
    missing = cell["points"] * (len(jobs) - len(ok_jobs))
    err = median = gap_max = 0.0 if ok_jobs else float("inf")
    below = -float("inf") if ok_jobs else float("inf")
    for j in ok_jobs:
        g = j.inputs["g"]
        e64 = refs.mps_energy_f64_general(j.outputs["As"], g, state["device"])
        gap = e64 - ref.tfim_energy_exact(g)
        err = max(err, float(np.max(np.abs(j.outputs["energies"].astype(np.float64) - e64))))
        median, gap_max = max(median, float(np.median(gap))), max(gap_max, float(np.max(gap)))
        below = max(below, float(np.max(-gap)))
    return {
        "energy_err_max": check_entry(err, cell["limits"]["energy_err_max"]),
        "gap_median": check_entry(median, cell["limits"]["gap_median"]),
        "gap_max": check_entry(gap_max, cfg["accuracy"]["gap_max"]),
        "below_exact": check_entry(below, cell["limits"]["below_exact"]),
        "answers_missing": check_entry(missing, 0),
    }
