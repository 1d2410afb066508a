"""Reduction of a ``torch.profiler`` trace (its Chrome JSON export) to what
the per-layer metrics read: the traced window, the device's busy time as
the union of kernel, copy and set intervals, kernel time and launches by
name, and the longest idle stretches named by what the host was doing.

Times in the export are microseconds on one clock for host and device.
"""

from __future__ import annotations

import json
from collections import defaultdict
from typing import Dict, List, NamedTuple, Tuple

from portbench.yardstick import stats

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "python_function", "cuda_runtime")
WINDOW_SPAN = "portbench.window"


class Trace(NamedTuple):
    window_s: float
    busy_s: float
    kernels: List[Tuple[str, float, float]]     # (name, start us, dur us)
    device: List[Tuple[str, float, float]]      # kernels, copies and sets
    host: List[Tuple[str, float, float]]        # the window's thread's
    #                                             host spans and operations

    def kernel_seconds(self, pattern: str) -> float:
        """Device seconds of the kernels whose name contains ``pattern``."""
        return sum(d for n, _s, d in self.kernels if pattern in n) * 1e-6

    def kernel_count(self) -> int:
        return len(self.kernels)

    def top_device_ops(self, n: int = 10) -> List[List]:
        """The ``n`` device operations (by name) that took most time, s."""
        total: Dict[str, float] = defaultdict(float)
        for name, _s, d in self.device:
            total[name] += d * 1e-6
        return [[k, v] for k, v in sorted(total.items(),
                                          key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n: int = 10) -> List[List]:
        """The idle stretches of the window summed by the innermost host
        span or operation of the window's thread running at each one's
        middle, ``n`` largest, s.  A stretch inside no span but the
        window is ``host python``."""
        lo, hi = _window(self.host)
        busy = [(s, s + d) for _n, s, d in self.device]
        by: Dict[str, float] = defaultdict(float)
        # by start, an enclosing span before the spans it encloses
        spans = sorted(((s, s + d, name) for name, s, d in self.host
                        if name != WINDOW_SPAN),
                       key=lambda t: (t[0], -t[1]))
        stack: List[Tuple[float, str]] = []       # (end, name), nested
        at = 0
        for g0, g1 in stats.gaps(busy, lo, hi):
            mid = 0.5 * (g0 + g1)
            while at < len(spans) and spans[at][0] <= mid:
                s, e, name = spans[at]
                while stack and stack[-1][0] < s:
                    stack.pop()
                stack.append((e, name))
                at += 1
            while stack and stack[-1][0] < mid:
                stack.pop()
            name = stack[-1][1] if stack else "host python"
            by[name] += (g1 - g0) * 1e-6
        return [[k, v] for k, v in sorted(by.items(),
                                          key=lambda kv: -kv[1])[:n]]


def _window(host) -> Tuple[float, float]:
    spans = [(s, s + d) for name, s, d in host if name == WINDOW_SPAN]
    if not spans:
        raise ValueError(f"the trace holds no {WINDOW_SPAN!r} span")
    return spans[0]


def load(path: str) -> Trace:
    """Read a Chrome trace written by ``prof.export_chrome_trace``; the
    window is the harness's ``portbench.window`` span."""
    with open(path, encoding="utf-8") as f:
        events = json.load(f)
    if isinstance(events, dict):
        events = events.get("traceEvents", [])
    kernels, device, host, threads = [], [], [], []
    for ev in events:
        if ev.get("ph") != "X" or "dur" not in ev:
            continue
        cat = ev.get("cat", "")
        item = (str(ev.get("name", "")), float(ev["ts"]), float(ev["dur"]))
        if cat in DEVICE_CATS:
            device.append(item)
            if cat == "kernel":
                kernels.append(item)
        elif cat in HOST_CATS:
            threads.append((ev.get("pid"), ev.get("tid")))
            host.append(item)
    # the host view keeps the thread that opened the window
    mine = {threads[i] for i, it in enumerate(host) if it[0] == WINDOW_SPAN}
    host = [it for it, th in zip(host, threads) if th in mine]
    lo, hi = _window(host)
    inside = [it for it in device if it[1] < hi and it[1] + it[2] > lo]
    busy = stats.union_length(((s, s + d) for _n, s, d in inside), lo, hi)
    return Trace(window_s=(hi - lo) * 1e-6, busy_s=busy * 1e-6,
                 kernels=[k for k in kernels if lo <= k[1] < hi],
                 device=inside, host=host)
