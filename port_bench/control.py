"""Readings that set the limits of a cell's comparison, in one process.

    python3 -m port_bench.control --workload <name> --side program|control --seeds 1,2,3 --jobs 2 [--prec tf32]

``--side program``: the program's set-up and ``--jobs`` jobs for each seed,
as a run makes them, then the comparison's numbers (the lower readings,
from sound runs).  ``--side control``: the plain reference in the
program's place at ``--prec`` (TF32 by default: the step below the
float32-with-TF32-off the configurations state), the same jobs and the
same numbers (the upper readings).  Prints one JSON line a seed and, with
``--out``, writes them all to that file.  The benchmark's own runs never
run this.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def readings(root: Path, workload: str, side: str, seed: int, jobs: int, prec: str, device) -> dict:
    from port_bench.harness import Job, load_spec

    spec = load_spec(root, workload)
    drv, cfg, cell = spec.driver, spec.config, spec.traffic
    t0 = time.perf_counter()
    state = (drv.setup if side == "program" else drv.control_setup)(cfg, cell, seed, device)
    done = []
    for index in range(jobs):
        inputs = drv.job_inputs(cfg, cell, seed, index)
        a = time.perf_counter()
        out = drv.run_job(state, inputs) if side == "program" else drv.control_job(state, inputs, prec)
        done.append(Job(a, time.perf_counter(), drv.work(cfg, cell), inputs, out))
    checks = drv.check(cfg, cell, state, done)
    return {"workload": workload, "side": side, "prec": prec if side == "control" else "program", "seed": seed,
            "jobs": jobs, "seconds": time.perf_counter() - t0,
            "checks": {k: c["value"] for k, c in checks.items()}, "correct": all(c["ok"] for c in checks.values())}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--side", choices=("program", "control"), required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--jobs", type=int, default=1)
    p.add_argument("--prec", default="tf32")
    p.add_argument("--device", default="cuda:0")
    p.add_argument("--out")
    args = p.parse_args(argv)

    import torch

    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        print("port_bench.control: no CUDA card", file=sys.stderr)
        return 2
    rows = []
    for seed in (int(s) for s in args.seeds.split(",")):
        rows.append(readings(ROOT, args.workload, args.side, seed, args.jobs, args.prec, torch.device(args.device)))
        print(json.dumps(rows[-1]), flush=True)
        if args.out:
            Path(args.out).parent.mkdir(parents=True, exist_ok=True)
            Path(args.out).write_text("\n".join(json.dumps(r) for r in rows) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
