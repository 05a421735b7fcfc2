"""Host time of the chart sweep's evaluations, the spans ``chart.evaluate``
(each descent's final 200-matvec read of its returned parameters, and each
refine pass's read of the neighbours' parameters), in ms a job: their sum
in the spans-on job of the traced run (``port_bench.spans``)."""
from port_bench import spans


def read(run):
    d = spans.durations_ms(run, "chart.evaluate")
    return sum(d) if d else None
