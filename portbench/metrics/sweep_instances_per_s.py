"""Instances of all whole sweeps in the window over the window, host
clock; the window ends with the first sweep to return after --seconds."""

from portbench.yardstick import stats


def read(run):
    sweeps = run.counters.get("sweeps")
    if not sweeps or run.t_window1 is None:
        return None
    return stats.rate(run.counters["instances_per_sweep"] * sweeps,
                      run.t_window1 - run.t_window0)
