"""Set-up: process start to the first timed call (imports, CUDA start,
the kernels' build on a checkout's first run, input generation, warm-up
at the cell's shapes), host clock."""


def read(run):
    if run.t_window0 is None:
        return None
    return run.t_window0 - run.t_start
