"""Share (%) of the card's idle time (the gaps between device operations)
in the spans-on profiled job of the traced run (``port_bench.spans``)
during which the sweep driver's start, the span ``sweep.init``, is
open."""
from port_bench import spans


def read(run):
    return spans.idle_pct_in(run, "sweep.init")
