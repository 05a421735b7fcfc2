"""Host calls that launch work on the card (``yardstick.LAUNCH_CALLS``)
whose start lies inside an adam step of the chart sweep, the span
``chart.step`` (autograd's device thread's launches included: they lie
inside the step), in the spans-on profiled job of the traced run
(``port_bench.spans``), over the number of steps: calls a step."""
from port_bench import spans


def read(run):
    got = spans.launches_in(run, "chart.step")
    return None if got is None else got[0] / got[1]
