"""Host time of the sweep driver's start, the span ``sweep.init`` (the
coupling matrices, the restarts' expand and the QR of the start normals),
in ms a job: the spans-on job of the traced run (``port_bench.spans``)."""
from port_bench import spans


def read(run):
    d = spans.durations_ms(run, "sweep.init")
    return sum(d) if d else None
