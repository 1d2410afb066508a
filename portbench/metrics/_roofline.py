"""A kernel's share of its roofline over the traced sweep: the frozen
bound of every recorded call (its shapes and live rows) summed, over the
device time of the kernel's launches by name."""

from portbench import recording
from portbench.yardstick import bounds


def share(run, wrapper, kernel_names):
    if run.trace is None:
        return None
    bound = sum(bounds.bound_ms(w)[0] for name, w in
                recording.works(run.calls) if name == wrapper)
    device_ms = 1e3 * sum(run.trace.kernel_seconds(k) for k in kernel_names)
    if bound <= 0 or device_ms <= 0:
        return None
    return 100.0 * bound / device_ms
