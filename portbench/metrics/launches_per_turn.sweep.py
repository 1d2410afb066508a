"""Kernels the device ran in the traced sweep (the profiler's kernel
events) over the turns it dispatched."""


def read(run):
    turns = run.counters.get("turns_traced")
    if run.trace is None or not turns:
        return None
    return run.trace.kernel_count() / turns
