"""Share (%) of the card's idle time (the gaps between device operations)
in the spans-on profiled job of the traced run (``port_bench.spans``)
during which an adam step of the chart sweep, the span ``chart.step`` with
the spans inside it, is open."""
from port_bench import spans


def read(run):
    return spans.idle_pct_in(run, "chart.step")
