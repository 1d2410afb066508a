"""What the host gave a run: readings taken before and after the window,
printed among the run's notes, so that a rate that moves between runs can
be set beside the host's own speed.

* ``probe_ms``: a fixed pure-Python loop, timed at each end of the window
  (the host's speed for the kind of work the sweeps' host side does);
* ``cpu_pct``: this process's CPU time over the window's wall time.
"""

from __future__ import annotations

import time
from typing import Dict

PROBE_ITERATIONS = 1_000_000


def probe_ms() -> float:
    t = time.perf_counter()
    acc = 0
    for i in range(PROBE_ITERATIONS):
        acc += i & 7
    return 1e3 * (time.perf_counter() - t)


def snapshot() -> Dict[str, float]:
    return {"t": time.perf_counter(), "cpu": time.process_time(),
            "probe_ms": probe_ms()}


def between(a: Dict[str, float], b: Dict[str, float]) -> str:
    """One line of notes for the stretch from snapshot ``a`` to ``b``."""
    cpu_pct = 100.0 * (b["cpu"] - a["cpu"]) / (b["t"] - a["t"])
    return (f"host probe_ms {a['probe_ms']:.1f} {b['probe_ms']:.1f}, "
            f"cpu_pct {cpu_pct:.1f}")
