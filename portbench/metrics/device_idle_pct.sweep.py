"""The device's idle share of the traced sweep."""

from portbench.metrics import _idle


def read(run):
    return _idle.share(run)
