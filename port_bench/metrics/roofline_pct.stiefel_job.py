"""Least time of one Stiefel sweep job's counted work over the device's
busy time in the profiled job, in %.  The work is the algorithm's
(``port_bench.stiefel_work``: per row and step the unroll forward and
backward, the energy forward and backward, the projections and the
Newton-Schulz polar factor; then the readout: the transfer matrix's
power by 40 squarings, the projection, the matvecs), so it reads the same
whatever implements the step; the least time is ``yardstick.bound_s`` of
the job's flops and bytes."""
from port_bench import stiefel_work, yardstick


def read(run):
    if run.trace is None or run.trace.busy_s <= 0:
        return None
    cfg, cell = run.spec.config, run.spec.traffic
    flops, nbytes = stiefel_work.job_work(cell["points"], cfg["restarts"], cfg["D"], cfg["steps"],
                                          cfg["recycle_iters"], cfg["final_iters"])
    return 100.0 * yardstick.bound_s(flops, nbytes) / run.trace.busy_s
