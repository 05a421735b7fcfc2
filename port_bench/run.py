"""Run one cell of the port's benchmark once and print its result line.

    python3 -m port_bench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds ``BENCHMARK.json``, ``port_bench/``
and the program, ``qmps_torch/``.  The last line of standard output is one
JSON object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the
cell's end-to-end metrics with ``--trace 0``, its per-layer metrics with
``--trace 1``), ``device`` (with ``busy_s`` and ``window_s`` when traced),
``breakdown`` when traced, and last ``checks``, each number the comparison
read beside its limit.  The same numbers end standard error.

The run needs CUDA cards, as many as the cell asks for: without them it
exits 2 and prints no result.  It keeps every build and kernel cache in
the checkout (``qmps_torch/_build/`` for the kernels, ``.bench_cache/``
for the rest), so only a checkout's first run builds.
"""
import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
CACHES = {"TRITON_CACHE_DIR": "triton", "TORCH_EXTENSIONS_DIR": "torch_extensions", "CUDA_CACHE_PATH": "cuda"}
THREADS = "4"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    for var, sub in CACHES.items():
        os.environ[var] = str(ROOT / ".bench_cache" / sub)
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[var] = THREADS

    import torch

    from port_bench.harness import load_spec, run_cell

    chips = load_spec(ROOT, args.workload).workload["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"port_bench: {args.workload} needs {chips} CUDA card(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    torch.set_num_threads(int(THREADS))
    result, _ = run_cell(ROOT, args.workload, args.seed, args.seconds, bool(args.trace), "cuda:0", T_PROCESS,
                         log=print)
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
