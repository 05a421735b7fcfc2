"""Least time of the profiled Stiefel job's environment unroll over the
device time of the kernels that carry it (device operations whose name
holds ``stiefel_unroll_``), in %.  The work is the algorithm's, counted as
``port_bench.stiefel_work`` counts it, per row: each step's ``recycle_iters``
power matvecs with their normalisations forward and twice that backward,
then the readout's ``final_iters`` forward; the least time is
``yardstick.bound_s`` of those flops (the bytes, A and r in and out, bound
it far less).  None where no such kernel ran (a program that unrolls by
plain autograd)."""
from port_bench import stiefel_work, yardstick


def read(run):
    if run.trace is None:
        return None
    spent = sum(s for name, s in run.trace.device_ops if "stiefel_unroll_" in name)
    if spent <= 0:
        return None
    cfg, cell = run.spec.config, run.spec.traffic
    D = cfg["D"]
    matvec = stiefel_work.CMAC * stiefel_work.matvec_cmacs(D) + 6 * D * D
    rows = cell["points"] * cfg["restarts"]
    flops = rows * (cfg["steps"] * 3 * cfg["recycle_iters"] + cfg["final_iters"]) * matvec
    return 100.0 * yardstick.bound_s(flops, 0) / spent
