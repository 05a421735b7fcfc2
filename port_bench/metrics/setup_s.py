"""Process start to the window's start: imports, the kernels' library (built
there on a checkout's first run), the cell's warm-up and the traffic's own
set-up (host clock)."""


def read(run):
    return run.setup_s
