"""Closed-loop protocol sweeps through ``repro_torch.engine.run_sweep``.

The mix is a grid, data sets × ε × seeds, of two-party instances of one
selector: instance ``i`` takes data set ``i % G``, ε ``(i // G) % E`` and
seed index ``i // (G·E)``, its shards drawn with the seed ``[--seed, seed
index]``; every ``noisy_every``-th instance has its labels flipped at
``noise`` (seed ``[--seed, seed index, 1]``) and ε ``noisy_eps``, which it
cannot meet, so it runs the whole turn budget.  One client sends the whole
grid to ``run_sweep`` again as soon as the last sweep returns.

The window runs from the first timed call to the return of the first
sweep that ends after ``--seconds``; every sweep in it counts whole.  With
``--trace 1`` the first sweep of the window runs under the profiler with
the kernel and layer wrappers of :mod:`portbench.recording`, and the
packer is timed alone on the same grid before the window.

After the window every sweep's answers must equal the first's, and a
sample drawn from the seed (with the longest instances in it) is run
again by the plain reference of :mod:`portbench.reference`; its numbers
against the limits decide ``correct``.
"""

from __future__ import annotations

import gc
import time
from typing import Any, Dict, List

import numpy as np

from portbench import recording
from portbench.yardstick import datasets

COMM = ("points", "scalars", "bits", "messages", "rounds")


class Grid:
    """The generated grid: per instance its shards, ε and noise flag."""

    def __init__(self, shards, eps, noisy):
        self.shards, self.eps, self.noisy = shards, eps, noisy


def make_grid(config: Dict[str, Any], traffic: Dict[str, Any],
              seed: int) -> Grid:
    gens = [datasets.GENERATORS[g] for g in traffic["datasets"]]
    eps_list = traffic["eps"]
    G, E = len(gens), len(eps_list)
    B = G * E * int(traffic["seeds"])
    shards, eps, noisy = [], [], []
    for i in range(B):
        s = i // (G * E)
        sh = gens[i % G](n_per_node=config["n_per_node"], k=config["k"],
                         seed=[seed, s])
        bad = traffic.get("noisy_every", 0) and i % traffic["noisy_every"] == 0
        if bad:
            sh = datasets.add_label_noise(sh, traffic["noise"],
                                          seed=[seed, s, 1])
        shards.append(sh)
        eps.append(traffic["noisy_eps"] if bad else eps_list[(i // G) % E])
        noisy.append(bool(bad))
    return Grid(shards, np.asarray(eps), np.asarray(noisy))


class State:
    def __init__(self, grid, instances, selector, opts, device):
        self.grid, self.instances = grid, instances
        self.selector, self.opts, self.device = selector, opts, device
        self.sweeps: List[list] = []


def _options(config, selector, device):
    opts = dict(config[selector])
    opts["device"] = device
    return opts


def prepare(run) -> State:
    from repro_torch.engine import ProtocolInstance

    selector = run.traffic["selector"]
    t = time.perf_counter()
    grid = make_grid(run.config, run.traffic, run.seed)
    instances = [ProtocolInstance(sh, float(e), selector)
                 for sh, e in zip(grid.shards, grid.eps)]
    run.span("setup.generate", time.perf_counter() - t)
    run.counters["instances_per_sweep"] = len(instances)
    return State(grid, instances, selector,
                 _options(run.config, selector, run.device), run.device)


def _sweep(state):
    from repro_torch import engine
    return engine.run_sweep(state.instances, **state.opts)


def _sync(device):
    if device == "cuda":
        import torch
        torch.cuda.synchronize()


def warm(run, state) -> None:
    """One whole sweep at the cell's shapes: the kernels build (on a
    checkout's first run) and load, and the allocator fills."""
    t = time.perf_counter()
    _sweep(state)
    _sync(state.device)
    run.span("setup.warm", time.perf_counter() - t)


def _pack_alone(run, state) -> None:
    """The packer alone on the cell's grid, host clock, synchronised."""
    from repro_torch.engine import state as est

    opts = state.opts
    t = time.perf_counter()
    if state.selector == "median":
        packed = est.pack_instances(state.instances,
                                    n_angles=opts["n_angles"],
                                    max_epochs=opts["max_epochs"],
                                    device=state.device)
    else:
        packed = est.pack_instances_maxmarg(
            state.instances, max_epochs=opts["max_epochs"],
            max_support=opts["max_support"], device=state.device)
    _sync(state.device)
    run.span("pack", time.perf_counter() - t)
    del packed


def measure(run, state) -> None:
    from repro_torch.engine import hotloop

    from portbench import harness

    if run.traced:
        _pack_alone(run, state)
    B = len(state.instances)
    # the grid and every sweep's answers, which the benchmark keeps for the
    # comparison, go to the collector's permanent generation, so that its
    # full collections scan only what the program itself keeps alive
    gc.collect()
    gc.freeze()
    run.t_window0 = t0 = time.perf_counter()
    while True:
        t = time.perf_counter()
        mark = len(hotloop.KEY_LOG)
        if run.traced and not state.sweeps:
            with harness.profiled(run), recording.recording(run.calls):
                res = _sweep(state)
            run.counters["turns_traced"] = len(hotloop.KEY_LOG) - mark
        else:
            res = _sweep(state)
            _sync(state.device)
            run.span("sweep", time.perf_counter() - t)
            run.counters["turns_per_sweep"] = len(hotloop.KEY_LOG) - mark
        state.sweeps.append(res)
        gc.freeze()
        now = time.perf_counter()
        if now - t0 >= run.seconds:
            break
    run.t_window1 = now
    run.attempted = B * len(state.sweeps)
    run.failed = sum(r is None for res in state.sweeps for r in res)
    run.counters["sweeps"] = len(state.sweeps)
    gc.unfreeze()
    del hotloop.KEY_LOG[:]


def _answer(r):
    """An answer as plain numbers: counters, epochs, converged, and the
    separator (w, b)."""
    c = r.comm
    w = np.asarray(r.classifier.w, dtype=np.float64)
    return ([c[k] for k in COMM], int(r.rounds), bool(r.converged),
            np.concatenate([w, [float(r.classifier.b)]]))


def _same(a, b) -> bool:
    return (a[0] == b[0] and a[1] == b[1] and a[2] == b[2]
            and np.array_equal(a[3], b[3]))


def sample_indices(grid: Grid, lim: Dict[str, Any], seed: int) -> np.ndarray:
    """The compared instances: ``sample`` drawn from the seed over the whole
    grid and ``sample_longest`` of the noisy ones (which run the whole
    turn budget), sorted."""
    rng = np.random.default_rng([seed, 7])
    noisy = np.flatnonzero(grid.noisy)
    clean = np.flatnonzero(~grid.noisy)
    pick = [rng.choice(clean, size=min(lim["sample"], len(clean)),
                       replace=False)]
    if len(noisy):
        pick.append(rng.choice(noisy, size=min(lim["sample_longest"],
                                               len(noisy)), replace=False))
    return np.sort(np.concatenate(pick))


def reference_answers(run, grid: Grid, idx: np.ndarray, dtype,
                      device) -> List[tuple]:
    """The plain reference's answers for instances ``idx``, in blocks,
    inputs in ``dtype``."""
    import torch

    from portbench.reference import maxmarg as ref_mm
    from portbench.reference import median as ref_med

    cfg = run.config
    sel = run.traffic["selector"]
    block = int(run.limits.get("block", 64))
    out = []
    for s in range(0, len(idx), block):
        part = idx[s:s + block]
        X = torch.tensor(np.stack([[np.asarray(X_, np.float32)
                                    for X_, _y in grid.shards[i]]
                                   for i in part]), device=device).to(dtype)
        y = torch.tensor(np.stack([[np.asarray(y_, np.int32)
                                    for _X, y_ in grid.shards[i]]
                                   for i in part]), device=device)
        n_total = (y != 0).sum(dim=(1, 2)).cpu().numpy()
        budget = torch.tensor([int(np.floor(float(grid.eps[i]) * n))
                               for i, n in zip(part, n_total)],
                              device=device)
        if sel == "median":
            r = ref_med.run(X, y, budget, dtype=dtype, **cfg["median"])
            sep_w = -r["h_v"].double()
            sep_b = r["h_t"].double()
            max_epochs = cfg["median"]["max_epochs"]
        else:
            r = ref_mm.run(X, y, budget, dtype=dtype, **cfg["maxmarg"])
            sep_w, sep_b = r["h_w"].double(), r["h_b"].double()
            max_epochs = cfg["maxmarg"]["max_epochs"]
        comm = torch.stack([r[c] for c in COMM], dim=1).cpu().numpy()
        conv = r["converged"].cpu().numpy()
        ep = r["epochs"].cpu().numpy()
        sw = sep_w.cpu().numpy()
        sb = sep_b.cpu().numpy()
        for j in range(len(part)):
            out.append(([int(v) for v in comm[j]],
                        int(ep[j]) if conv[j] else max_epochs,
                        bool(conv[j]), np.concatenate([sw[j], [sb[j]]])))
    return out


def exact(limits: Dict[str, Any]) -> bool:
    """Whether the cell compares its separators bit for bit: its limits
    hold ``separator_gap`` at 0."""
    return limits["limits"].get("separator_gap") == 0


def numbers(got: List[tuple], want: List[tuple],
            exact: bool) -> Dict[str, float]:
    """The numbers a comparison can hold against its limits: how many
    answers differ from the reference in a decision (a counter, the epochs
    or convergence), and among the answers whose decisions agree the widest
    gap between separators, |Δ(w, b)| over |(w, b)| of the reference
    (``separator_gap``), and between their directions, |Δ u| with u = (w,
    b) / |(w, b)| on each side (``direction_gap``: the line each answer
    draws, without the scale).  Where the separators are compared exactly
    (MEDIAN's) that holds for every answer.  Where they are compared within
    rounding (MAXMARG's), an instance that never meets its budget is left
    out of the gaps: it ends on its last proposal, which on data no line
    separates is an iterate of a subgradient walk at step sizes of up to
    1 / (2 λ), so its floats are noise; its decisions are not."""
    mismatch = 0
    gap = direction = 0.0
    for g, w in zip(got, want):
        if g[0] != w[0] or g[1] != w[1] or g[2] != w[2]:
            mismatch += 1
            continue
        if not (w[2] or exact):
            continue
        scale = max(float(np.linalg.norm(w[3])), 1e-30)
        gap = max(gap, float(np.linalg.norm(g[3] - w[3])) / scale)
        unit_g = g[3] / max(float(np.linalg.norm(g[3])), 1e-30)
        direction = max(direction,
                        float(np.linalg.norm(unit_g - w[3] / scale)))
    return {"decisions_differing": float(mismatch), "separator_gap": gap,
            "direction_gap": direction}


def compare(run, state) -> None:
    import torch

    first = [_answer(r) for r in state.sweeps[0]]
    differing = 0
    for res in state.sweeps[1:]:
        if not all(_same(_answer(r), a) for r, a in zip(res, first)):
            differing += 1
    last = state.sweeps[-1]
    idx = sample_indices(state.grid, run.limits, run.seed)
    got = [_answer(last[i]) for i in idx]
    # the program's state is freed before the reference runs
    state.sweeps = []
    state.instances = []
    if state.device == "cuda":
        torch.cuda.empty_cache()
    want = reference_answers(run, state.grid, idx, torch.float32,
                             state.device)
    run.check("sweeps_differing", differing)
    # the cell's limits file names the numbers it compares
    for name, value in numbers(got, want, exact(run.limits)).items():
        if name in run.limits["limits"]:
            run.check(name, value)
