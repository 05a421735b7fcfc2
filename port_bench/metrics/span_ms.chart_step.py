"""Host time of one adam step of the chart sweep, the span ``chart.step``
(the brick wall's build, the warm-environment energy with its 24-matvec
unroll, autograd's backward through both, the fused adam update and the
rate's schedule), in ms: the median over the steps of the spans-on job of
the traced run (``port_bench.spans``)."""
from port_bench import spans


def read(run):
    return spans.median(spans.durations_ms(run, "chart.step"))
