"""Host time of one Stiefel descent step, the span ``stiefel.step`` (the
warm-environment energy with its power-matvec unroll, its autograd
backward, the projections and the Newton-Schulz polar retraction), in ms:
the median over the steps of the spans-on job of the traced run
(``port_bench.spans``)."""
from port_bench import spans


def read(run):
    return spans.median(spans.durations_ms(run, "stiefel.step"))
