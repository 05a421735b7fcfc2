"""Host calls that launch work on the card (``yardstick.LAUNCH_CALLS``)
whose start lies inside a sweep step, the span ``sweep.step``, in the
spans-on profiled job of the traced run (``port_bench.spans``), over the
number of steps: calls a step."""
from port_bench import spans


def read(run):
    got = spans.launches_in(run, "sweep.step")
    return None if got is None else got[0] / got[1]
