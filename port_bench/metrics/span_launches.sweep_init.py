"""Host calls that launch work on the card (``yardstick.LAUNCH_CALLS``)
whose start lies inside the sweep driver's start, the span
``sweep.init``, in the spans-on profiled job of the traced run
(``port_bench.spans``): calls a job."""
from port_bench import spans


def read(run):
    got = spans.launches_in(run, "sweep.init")
    return None if got is None else float(got[0])
