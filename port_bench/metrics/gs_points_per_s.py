"""Work of all jobs over the window, from its start to the last job's end
(host clock)."""


def read(run):
    return run.rate()
