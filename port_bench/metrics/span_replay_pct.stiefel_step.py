"""Share (%) of the Stiefel descent's steps, the spans ``stiefel.step`` of
the spans-on job of the traced run (``port_bench.spans``), that replayed a
captured CUDA graph of the step, the spans ``stiefel.replay`` inside them:
100 x replays over steps.  None where no step replayed, as in a program
that never captures the step."""
from port_bench import spans


def read(run):
    if not spans.available(run):
        return None
    names = [s.name for s in run.spans]
    steps, replays = names.count("stiefel.step"), names.count("stiefel.replay")
    return 100.0 * replays / steps if steps and replays else None
