"""90th percentile of the jobs' times, each from the call to its results on
the host (host clock), over every job of the window."""
import numpy as np


def read(run):
    return float(np.percentile(run.durations, 90))
