"""1 - device busy (the union of the device operations' intervals in the
profiled Stiefel sweep job) over the host time of the same job run
unprofiled, in %."""
from port_bench import yardstick


def read(run):
    if run.trace is None:
        return None
    return yardstick.idle_pct(run.trace.busy_s, run.host_s)
