"""Wrappers installed from outside the program, at run time, where the
engine looks its kernels and layers up: each recorded kernel call keeps
the frozen work of its inputs, and each layer call is a named span in the
profiler's trace.  Nothing of the program is edited; every wrapper is
taken out again when the block ends.

A kernel call is kept as its wrapper name, the shapes of its inputs (meta
tensors) and the inputs themselves by reference (the labels its live
count comes from: the engine never writes into a kernel's inputs), so
recording launches nothing on the device; :func:`works` turns them into
:class:`~portbench.yardstick.bounds.Work` once the traced block is over.
"""

from __future__ import annotations

import contextlib
import functools
import importlib
from typing import Callable, List

import torch

from portbench.yardstick import bounds

# (module, attribute) where the engine looks each kernel wrapper up at call
# time, and the wrapper's name
KERNEL_SITES = (
    ("repro_torch.engine.dataplane", "median_cut", "median_cut_scores"),
    ("repro_torch.kernels.pegasos", "pegasos_stage", "pegasos_stage"),
)

# the inputs a call's live count needs, by position: the cut scan's labels,
# the Pegasos stage's labels and latch flags
KEPT = {"median_cut_scores": (5,), "pegasos_stage": (1, 6)}

# (module, attribute, span name): the layers' entry points
LAYER_SITES = (
    ("repro_torch.engine.median", "pack_instances", "layer.pack"),
    ("repro_torch.engine.maxmarg", "pack_instances_maxmarg", "layer.pack"),
    ("repro_torch.engine.median", "run_hot", "layer.hotloop"),
    ("repro_torch.engine.maxmarg", "run_hot", "layer.hotloop"),
    ("repro_torch.engine.hotloop", "wait_view", "layer.host_view"),
    ("repro_torch.core.classifiers", "_svm_solve_batch", "layer.solver"),
)


def _meta(a):
    return torch.empty(a.shape, dtype=a.dtype, device="meta") \
        if torch.is_tensor(a) else a


class _Kernel:
    """Stands in for a kernel wrapper: records the call, then runs it."""

    def __init__(self, fn, name, calls):
        self.fn, self.name, self.calls = fn, name, calls

    @property
    def launches(self):
        return self.fn.launches

    @launches.setter
    def launches(self, n):
        self.fn.launches = n

    def __call__(self, *args, **kw):
        keep = {i: args[i] for i in KEPT[self.name]}
        self.calls.append((self.name, tuple(_meta(a) for a in args), kw,
                           keep))
        return self.fn(*args, **kw)


def works(calls) -> List[tuple]:
    """``[(wrapper name, Work)]`` of the recorded calls.  A Pegasos stage
    that skips latched instances counts only the rows of the others."""
    out = []
    for name, metas, kw, kept in calls:
        if name == "median_cut_scores":
            live = int((kept[5] != 0).sum())
            w = bounds.cut_work(*metas, live=live)
        elif name == "pegasos_stage":
            y, found = kept[1], kept[6]
            rows = y != 0
            if kw.get("skip_latched"):
                rows = rows & ~found[:, None]
            # the live rows as labels of y's type, so bytes count as y's
            w = bounds.pegasos_work(metas[0], rows.to(y.dtype), *metas[2:],
                                    nsteps=kw["nsteps"])
        else:
            continue
        out.append((name, w))
    return out


def _span(fn: Callable, name: str):
    @functools.wraps(fn)
    def wrapped(*args, **kw):
        with torch.profiler.record_function(name):
            return fn(*args, **kw)
    return wrapped


@contextlib.contextmanager
def recording(calls: list):
    """While open, every kernel call the engine makes through
    :data:`KERNEL_SITES` is appended to ``calls`` and every layer entry of
    :data:`LAYER_SITES` runs inside a named profiler span."""
    saved = []
    try:
        for modname, attr, name in KERNEL_SITES:
            owner = importlib.import_module(modname)
            fn = getattr(owner, attr)
            saved.append((owner, attr, fn))
            setattr(owner, attr, _Kernel(fn, name, calls))
        for modname, attr, name in LAYER_SITES:
            owner = importlib.import_module(modname)
            fn = getattr(owner, attr)
            saved.append((owner, attr, fn))
            setattr(owner, attr, _span(fn, name))
        yield calls
    finally:
        for owner, last, fn in reversed(saved):
            setattr(owner, last, fn)
