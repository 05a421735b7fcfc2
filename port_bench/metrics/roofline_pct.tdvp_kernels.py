"""Least time of the TDVP objective's forward (K4, with the left vector)
and adjoint (K5) over the device time of the kernels that carry them, in
%.  The work is the objective's, counted per element with a per-element
gate W read once (a frozen copy of the chip script's ``kernel_work``), so
it reads the same whatever kernel implements it; the least time of a
launch is ``yardstick.bound_s`` of the launch's batch."""
from port_bench import yardstick

#: kernel-name pattern -> (flops, bytes) per element of one launch
KERNELS = {"tdvp_fwd": (28344, 328), "tdvp_bwd": (4604, 588)}


def read(run):
    if run.trace is None:
        return None
    spec = run.spec
    return yardstick.kernel_roofline_pct(run.trace, KERNELS, spec.driver.kernel_batch(spec.config, spec.traffic))
