"""Host time of the Stiefel sweep's start, the spans ``stiefel.init`` (the
coupling matrices and the QR of the start normals, one a chunk), in ms a
job: the spans-on job of the traced run (``port_bench.spans``)."""
from port_bench import spans


def read(run):
    d = spans.durations_ms(run, "stiefel.init")
    return sum(d) if d else None
