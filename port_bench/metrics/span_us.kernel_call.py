"""Host time of one hand-kernel wrapper call, the spans ``kernel.<name>``
(validation, allocations, the stream, the C call, the error check and the
launch counter), in us: the median self time (duration less child spans)
over the wrapper calls of the spans-on job of the traced run
(``port_bench.spans``)."""
from port_bench import spans


def read(run):
    return spans.median(spans.kernel_self_us(run))
