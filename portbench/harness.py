"""One run of one cell: find its parts by name, set up, measure, trace,
check against the reference, and assemble the result line.

A cell of ``BENCHMARK.json`` names a configuration (``configs/<name>.json``)
and a traffic mix (``traffic/<name>.json``); the mix names the generator
(``generators/<generator>.py``) that makes it and drives the program.  Each
metric is read by ``metrics/<metric name>.py`` (a ``read(run)`` returning a
number, or None where it finds nothing to read), and the correctness
comparison's limits are ``limits/<cell name>.json``.  Adding a cell, a mix
or a metric adds files and edits none.
"""

from __future__ import annotations

import contextlib
import importlib.util
import json
import os
import sys
import tempfile
import time
from pathlib import Path
from types import ModuleType
from typing import Any, Dict, List, Optional

from portbench.yardstick import host

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FOREIGN = ("jax", "jaxlib", "flax", "repro")


class Run:
    """Everything one run knows; generators fill it, metric readers read it.

    ``spans`` holds host-clock seconds by name, ``counters`` counts,
    ``calls`` the kernel calls :mod:`portbench.recording` kept and
    ``trace`` the reduced profiler trace of a traced run."""

    def __init__(self, bench, cell, config, traffic, limits, *, seed,
                 seconds, trace, device, t_start):
        self.bench, self.cell, self.config = bench, cell, config
        self.traffic, self.limits = traffic, limits
        self.seed, self.seconds, self.traced = seed, seconds, trace
        self.device, self.t_start = device, t_start
        self.t_window0: Optional[float] = None
        self.t_window1: Optional[float] = None
        self.attempted = 0
        self.failed = 0
        self.spans: Dict[str, List[float]] = {}
        self.counters: Dict[str, float] = {}
        self.calls: List[Any] = []
        self.trace = None
        self.checks: Dict[str, Dict[str, float]] = {}
        self.notes: List[str] = []

    def span(self, name: str, seconds: float) -> None:
        self.spans.setdefault(name, []).append(seconds)

    def check(self, name: str, value: float) -> None:
        """Record a compared number beside its limit from the cell's
        limits file."""
        limit = self.limits["limits"][name]
        self.checks[name] = {"value": float(value), "limit": float(limit)}

    @property
    def correct(self) -> bool:
        missing = set(self.limits["limits"]) - set(self.checks)
        return (not missing and all(c["value"] <= c["limit"]
                                    for c in self.checks.values()))


def load_module(path: Path, name: str) -> ModuleType:
    """Import the file ``path`` as module ``name``."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _json(path: Path):
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def resolve(workload: str, root: Path = ROOT):
    """The cell's entry and its configuration, traffic and limits."""
    bench = _json(root / "BENCHMARK.json")
    cells = {c["name"]: c for c in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; cells: "
                         f"{sorted(cells)}")
    cell = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    config = _json(root / configs[cell["config"]]["file"])
    traffic = _json(HERE / "traffic" / f"{cell['traffic']}.json")
    limits = _json(HERE / "limits" / f"{workload}.json")
    return bench, cell, config, traffic, limits


def cell_metrics(bench, cell, kind: str) -> List[dict]:
    """The ``end_to_end`` or ``per_layer`` metrics this cell reports."""
    return [m for m in bench[kind]
            if "workloads" not in m or cell["name"] in m["workloads"]]


def read_metrics(run: Run, metrics: List[dict]) -> Dict[str, dict]:
    out = {}
    for m in metrics:
        if m["source"] == "device_trace" and run.device != "cuda":
            continue            # no device number from a host run
        reader = load_module(HERE / "metrics" / f"{m['name']}.py",
                             "portbench_metric_" + m["name"].replace(".", "_"))
        value = reader.read(run)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def foreign_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({name for name in sys.modules
                   if name.split(".")[0] in FOREIGN})


def refuse_foreign() -> None:
    found = foreign_modules()
    if found:
        raise ForeignImport(found)


@contextlib.contextmanager
def profiled(run: Run):
    """Trace the body with ``torch.profiler`` (host and device) inside a
    ``portbench.window`` span.  The trace is exported and reduced later,
    by :func:`read_trace`, so that its cost stays out of the window."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from portbench.yardstick import trace as trace_mod

    on_card = run.device == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    sync()
    prof = profile(activities=[ProfilerActivity.CPU]
                   + ([ProfilerActivity.CUDA] if on_card else []))
    prof.start()
    try:
        with record_function(trace_mod.WINDOW_SPAN):
            yield
            sync()
    finally:
        prof.stop()
        run.profile = prof


def read_trace(run: Run) -> None:
    """Export the profile of :func:`profiled` to a temporary file, reduce
    it into ``run.trace`` and delete the file."""
    from portbench.yardstick import trace as trace_mod

    prof = getattr(run, "profile", None)
    if prof is None:
        return
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        t = time.perf_counter()
        prof.export_chrome_trace(path)
        run.trace = trace_mod.load(path)
        run.notes.append(f"trace exported and read in "
                         f"{time.perf_counter() - t:.1f} s")
    finally:
        os.remove(path)
        run.profile = None


def execute(workload: str, seed: int, seconds: float, trace: bool, *,
            device: str = "cuda", t_start: Optional[float] = None,
            root: Path = ROOT, traffic_override: Optional[dict] = None,
            config_override: Optional[dict] = None,
            fault=None) -> Dict[str, Any]:
    """Run one cell and return its result record (the line ``run.py``
    prints).  ``traffic_override`` replaces keys of the traffic mix and
    ``fault`` breaks the timed path underneath (both for the harness's
    own tests), as ``config_override`` does the configuration's; a run on
    the CPU reports no device metrics."""
    t_start = time.perf_counter() if t_start is None else t_start
    bench, cell, config, traffic, limits = resolve(workload, root)
    if traffic_override:
        traffic = dict(traffic, **traffic_override)
    if config_override:
        config = dict(config, **config_override)
    gen = load_module(HERE / "generators" / f"{traffic['generator']}.py",
                      "portbench_generator_" + traffic["generator"])
    run = Run(bench, cell, config, traffic, limits, seed=seed,
              seconds=seconds, trace=trace, device=device, t_start=t_start)
    state = gen.prepare(run)
    if fault is not None:
        fault(run, state)
    gen.warm(run, state)
    before = host.snapshot()
    gen.measure(run, state)
    run.notes.append(host.between(before, host.snapshot()))
    memory_peak = None
    if device == "cuda":
        import torch
        torch.cuda.synchronize()
        memory_peak = int(torch.cuda.max_memory_allocated())
    refuse_foreign()
    read_trace(run)
    t = time.perf_counter()
    gen.compare(run, state)
    run.notes.append(f"compared in {time.perf_counter() - t:.1f} s")
    kind = "per_layer" if trace else "end_to_end"
    metrics = read_metrics(run, cell_metrics(bench, cell, kind))
    # the trace's reading, the reference and the metric readers run after
    # the window too: whatever they load counts as loaded in the window
    refuse_foreign()
    out: Dict[str, Any] = {"correct": run.correct,
                           "attempted": int(run.attempted),
                           "failed": int(run.failed), "metrics": metrics}
    dev: Dict[str, Any] = {"platform": "gpu" if device == "cuda" else "cpu"}
    if device == "cuda":
        import torch
        dev.update(kind=torch.cuda.get_device_name(0), count=1,
                   memory_peak_bytes=memory_peak)
    if trace and run.trace is not None:
        dev.update(busy_s=run.trace.busy_s, window_s=run.trace.window_s)
        out["breakdown"] = {"device_ops": run.trace.top_device_ops(10),
                            "idle_gaps": run.trace.idle_gaps(10)}
    out["device"] = dev
    out["notes"] = run.notes + [
        f"{k} {v[0]:.3f} s" for k, v in run.spans.items()
        if k.startswith("setup.")] + [
        "walls ms " + " ".join(f"{1e3 * x:.0f}"
                               for x in run.spans.get("sweep", []))]
    out["checks"] = run.checks
    return out


class ForeignImport(RuntimeError):
    """JAX or the JAX package was loaded in the measuring process."""

    def __init__(self, names):
        super().__init__(f"modules of JAX or the JAX package loaded: {names}")
        self.names = names
