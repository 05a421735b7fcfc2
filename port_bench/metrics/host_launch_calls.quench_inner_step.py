"""Host calls that launch work on the card (``yardstick.LAUNCH_CALLS``: a
CUDA graph's replay is one) over one profiled job, per driver step of the
job."""


def read(run):
    if run.trace is None or run.trace.launches == 0:
        return None
    spec = run.spec
    return run.trace.launches / spec.driver.steps(spec.config, spec.traffic)
