"""Least time of the energy objective's forward (K2) and adjoint (K3) over
the device time of the kernels that carry them, in %.  The work is the
objective's, counted per element (a frozen copy of the chip script's
``kernel_work``: three-product squarings, each input byte read once and
each output byte written once), so it reads the same whatever kernel
implements it; the least time of a launch is ``yardstick.bound_s`` of the
launch's batch."""
from port_bench import yardstick

#: kernel-name pattern -> (flops, bytes) per element of one launch
KERNELS = {"energy_fwd": (28180, 236), "energy_bwd": (23748, 428)}


def read(run):
    if run.trace is None:
        return None
    spec = run.spec
    return yardstick.kernel_roofline_pct(run.trace, KERNELS, spec.driver.kernel_batch(spec.config, spec.traffic))
