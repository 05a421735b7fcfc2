"""Job driver of ``tfim_deep_bw_d8``: one job is one D = 8 TFIM phase
diagram through the brick-wall circuit ansatz, ``sweep_ground_states(...,
ansatz="deep_bw")`` over the cell's ``points`` couplings with the
configuration's steps, rate, restarts and refine passes, and its energies
and parameters copied to the host.

The comparison reads the returned parameters in float64
(``reference_brickwork.wall_energy_f64``: the wall built at complex128, its
energy by ``reference_stiefel.mps_energy_f64_general``, on the run's
device):
- ``energy_err_max``: over every point of every job, the largest gap
  between a returned energy (the returned parameters' environment
  projected onto the dominant eigenspace, then 200 float32 matvecs) and
  the float64 energy of the returned parameters; its limit is the cell's,
  set from readings of the program and of the controls;
- ``gap_median``: the float64 energies above the exact energy, the worst
  job's median, against the cell's limit, set from readings below the
  configuration's stated bar: it reads the descent;
- ``gap_max``: the largest such gap over the window's first
  ``gap_max_jobs`` jobs (the cell's), against the stated bar: a fixed
  number of points, so a faster program, which fits more jobs in the
  window, is held to as many points as a slower one;
- ``below_exact``: the largest amount by which a float64 energy lies below
  the exact energy (negative: every one lies above by at least that
  much); no uniform MPS lies below it, so this guards the readout itself;
- ``answers_missing``: points not returned, or not finite.
"""
from __future__ import annotations

import numpy as np
import torch

from port_bench import reference as ref
from port_bench import reference_brickwork as refb
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
    """Adam steps of one descent; a job makes 1 + 2 x refine_passes
    descents."""
    return cfg["steps"]


def kernel_batch(cfg: dict, cell: dict) -> int:
    """Rows of each batched product: every point's every restart."""
    return cell["points"] * cfg["restarts"]


def start_params(start_seed: int, points: int, restarts: int, n_params: int) -> torch.Tensor:
    """(points, restarts, n_params) float64 starts, normal x 0.5, as the
    entry point draws them from a CPU ``torch.Generator`` seeded with
    ``start_seed``."""
    g = torch.Generator().manual_seed(start_seed)
    return torch.randn((points, restarts, n_params), generator=g, dtype=torch.float64) * 0.5


def _sweep(state: dict, inputs: dict, n_steps: int) -> dict:
    from qmps_torch.parallel import sweep_ground_states

    cfg = state["cfg"]
    es, ps = sweep_ground_states(
        inputs["g"], D=cfg["D"], ansatz=cfg["ansatz"], steps=n_steps, lr=cfg["lr"], restarts=cfg["restarts"],
        refine_passes=cfg["refine_passes"], generator=torch.Generator().manual_seed(inputs["start_seed"]),
        device=state["device"])
    return {"energies": es.cpu().numpy(), "params": ps.cpu().numpy()}


def setup(cfg: dict, cell: dict, seed: int, device) -> dict:
    """Warm every path of the program at the cell's own batch: one sweep of
    ``warmup_steps`` steps a descent with both refine passes."""
    state = {"cfg": cfg, "device": device}
    _sweep(state, _draw(cfg, cell["points"], _stream(seed, 0)), cfg["warmup_steps"])
    return state


def run_job(state: dict, inputs: dict) -> dict:
    return _sweep(state, inputs, state["cfg"]["steps"])


def control_setup(cfg: dict, cell: dict, seed: int, device) -> dict:
    return {"cfg": cfg, "device": device}


#: the control ``prec`` that runs the program itself with TF32 products
PROGRAM_TF32 = "program_tf32"


def control_job(state: dict, inputs: dict, prec: str) -> dict:
    """The reference in the program's place: the plain sweep at ``prec``
    from the same couplings and the same starts (one restart, the
    configuration's).  ``prec`` ``PROGRAM_TF32`` runs the program itself
    with TF32 allowed in its float32 and complex64 cuBLAS products (the
    circuit's build and its backward; the unroll kernels' sums stay
    float32): the lower precision a faster program could take."""
    cfg = state["cfg"]
    if prec == PROGRAM_TF32:
        import qmps_torch  # noqa: F401  (its first import pins full float32: before the flags are set)

        saved = torch.get_float32_matmul_precision(), torch.backends.cuda.matmul.allow_tf32
        torch.set_float32_matmul_precision("high")
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            return _sweep(state, inputs, cfg["steps"])
        finally:
            torch.set_float32_matmul_precision(saved[0])
            torch.backends.cuda.matmul.allow_tf32 = saved[1]
    if cfg["restarts"] != 1:
        raise ValueError("the plain deep_bw sweep takes one restart")
    p0 = start_params(inputs["start_seed"], inputs["g"].shape[0], 1, cfg["n_params"])[:, 0]
    es, ps = refb.deep_bw_sweep_plain(inputs["g"], p0.numpy(), cfg["D"], cfg["steps"], cfg["lr"],
                                      cfg["refine_passes"], prec, state["device"])
    return {"energies": es, "params": ps}


def answered(cfg: dict, cell: dict, outputs: dict) -> bool:
    e, p = outputs.get("energies"), outputs.get("params")
    return (e is not None and p is not None and e.shape == (cell["points"],)
            and p.shape == (cell["points"], cfg["n_params"]) and bool(np.isfinite(e).all() and np.isfinite(p).all()))


def check(cfg: dict, cell: dict, state: dict, jobs: list) -> dict:
    """The compared numbers: every point of every job, ``gap_max`` over the
    first ``cell["gap_max_jobs"]`` jobs."""
    ok = [(i, j) for i, j in enumerate(jobs) if answered(cfg, cell, j.outputs)]
    missing = cell["points"] * (len(jobs) - len(ok))
    err = median = gap_max = 0.0 if ok else float("inf")
    below = -float("inf") if ok else float("inf")
    for i, j in ok:
        g = j.inputs["g"]
        e64 = refb.wall_energy_f64(j.outputs["params"], g, cfg["D"], state["device"])
        gap = e64 - ref.tfim_energy_exact(g)
        err = max(err, float(np.max(np.abs(j.outputs["energies"].astype(np.float64) - e64))))
        median = max(median, float(np.median(gap)))
        below = max(below, float(np.max(-gap)))
        if i < cell["gap_max_jobs"]:
            gap_max = max(gap_max, float(np.max(gap)))
    return {
        "energy_err_max": check_entry(err, cell["limits"]["energy_err_max"]),
        "gap_median": check_entry(median, cell["limits"]["gap_median"]),
        "gap_max": check_entry(gap_max, cfg["accuracy"]["gap_max"]),
        "below_exact": check_entry(below, cell["limits"]["below_exact"]),
        "answers_missing": check_entry(missing, 0),
    }
