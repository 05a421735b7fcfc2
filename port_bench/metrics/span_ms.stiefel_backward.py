"""Host time of one Stiefel step's backward, the span ``stiefel.backward``
(the ``torch.autograd.grad`` call back through the unrolled power matvecs
and the energy, in the caller's thread, which waits for autograd's device
thread), in ms: the median over the steps of the spans-on job of the
traced run (``port_bench.spans``)."""
from port_bench import spans


def read(run):
    return spans.median(spans.durations_ms(run, "stiefel.backward"))
