"""Host time of one sweep step, the span ``sweep.step`` (the forward, the
gradient and the heavy-ball update with its retraction), in ms: the median
over the steps of the spans-on job of the traced run
(``port_bench.spans``)."""
from port_bench import spans


def read(run):
    return spans.median(spans.durations_ms(run, "sweep.step"))
