#!/usr/bin/env python3
"""Run the PyTorch port's MEDIAN sweep on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases (any failure exits non-zero; none is caught):

1. card and build — print the card's name and power limit, build every CUDA
   kernel of ``src/repro_torch/kernels/csrc`` with ``nvcc`` (timed);
2. kernels against their plain PyTorch versions on the card, integer-exact:
   the cut scan and the extremes scan at the smoke sweep's full-batch turn
   shape, the extremes scan at the sweep's widest turn, and crafted ties
   (duplicate points, bounds built from the points themselves, an absent
   class, all directions disallowed); each kernel timed with CUDA events
   beside its plain version;
3. the full-size sweep through ``repro_torch.engine.run_sweep`` on the card,
   with every kernel's launch count read around it;
4. the card against the CPU on a 48-instance subset with noisy tail
   instances: integer outputs exact, separators to 1e-6.

The smoke config is the shape of the JAX package's engine benchmark grid
(``benchmarks/engine_sweep.py``: data1/2/3 × ε ∈ {0.2, 0.1, 0.05, 0.025},
k=2, n_per_node=1000, 1024 angles, 32 epochs), widened to 256 seeds
(B=3072), with every 24th instance given 10% label noise and ε=0.02 so 128
sessions run the whole 64-turn budget on the compacted hot path.

The last line of standard output is ``{"ok": true, "device": {...}}``; the
line before it is the ``nvidia-smi`` name and power limit, and before that
one JSON line with every kernel's launches, error and times.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

SMOKE = dict(B=3072, n_per_node=1000, n_angles=1024, max_epochs=32,
             noisy_every=24)
SUBSET = 48            # card-against-CPU instances (two of them noisy)
PEAK_F32 = 67e12       # H100 SXM f32 FLOP/s outside the tensor cores
PEAK_BYTES = 3.35e12   # H100 SXM HBM3 bytes/s


def smoke_instances(B, n_per_node, noisy_every, engine, datasets):
    """The smoke grid: instance i is data{1,2,3}[i % 3] at ε[(i // 3) % 4],
    seed i // 12; every ``noisy_every``-th gets 10% label noise, ε=0.02."""
    gens = (datasets.data1, datasets.data2, datasets.data3)
    epss = (0.2, 0.1, 0.05, 0.025)
    out = []
    for i in range(B):
        shards = gens[i % 3](n_per_node=n_per_node, k=2, seed=i // 12)
        eps = epss[(i // 3) % 4]
        if i % noisy_every == 0:
            shards = datasets.add_label_noise(shards, 0.1, seed=i)
            eps = 0.02
        out.append(engine.ProtocolInstance(shards, eps))
    return out


def crafted_cut_inputs(V, device, seed=0):
    """Cut-scan inputs built to sit on every tie the scan has: duplicate
    points, bounds built by the port's own ``_append2`` from the scanned
    points (so their projections equal lo/hi exactly), an instance with no
    positive points, a padding-only instance, and one with every direction
    disallowed.  Returns ``(V, dir_ok, lo, hi, X, y)``."""
    import torch
    from repro_torch.engine.median import _append2

    rng = np.random.default_rng(seed)
    m = V.shape[0]
    B, n = 6, 64
    X = rng.normal(size=(B, n, 2)).astype(np.float32)
    y = np.where(rng.random((B, n)) < 0.5, 1, -1).astype(np.int32)
    X[:, 32:48] = X[:, 0:16]                  # duplicates, same labels
    X[:, 48:56] = X[:, 16:24]                 # duplicates, flipped labels
    y[:, 48:56] = -y[:, 16:24]
    y[2] = -1                                 # no positive class
    y[3] = 0                                  # padding only
    y[:, 60:] = 0                             # padding rows in every one
    dir_ok = rng.random((B, m)) < 0.8
    dir_ok[4] = False                         # every direction disallowed
    t = lambda a: torch.from_numpy(a).to(device)
    Vd = V.to(device)
    lo = torch.full((B, m), -np.inf, device=device)
    hi = torch.full((B, m), np.inf, device=device)
    # the bounds of a transcript holding rows 0..7 of each instance
    dummy_w = torch.zeros((B, 16, 2), device=device)
    dummy_y = torch.zeros((B, 16), dtype=torch.int32, device=device)
    fill = torch.zeros(B, dtype=torch.int32, device=device)
    for r in range(0, 8, 2):
        _append2(dummy_w, dummy_y, fill, lo, hi, t(X[:, r:r + 2].copy()),
                 t(y[:, r:r + 2].copy()),
                 torch.ones(B, dtype=torch.bool, device=device), Vd)
    return Vd, t(dir_ok), lo, hi, t(X), t(y)


def crafted_extremes_inputs(device, seed=0):
    """Extremes-scan inputs with ties on both classes: every row duplicated
    (the first of two equal extremes must win), a node without positives
    and a padding-only node.
    Returns ``(v, XW, yW)``."""
    import torch

    rng = np.random.default_rng(seed)
    B, k, nW = 5, 3, 70
    ang = rng.uniform(0, 2 * np.pi, B)
    v = np.stack([np.cos(ang), np.sin(ang)], -1).astype(np.float32)
    XW = rng.normal(size=(B, k, nW, 2)).astype(np.float32)
    yW = np.where(rng.random((B, k, nW)) < 0.5, 1, -1).astype(np.int32)
    XW[:, :, 40:60] = XW[:, :, 0:20]          # every row twice
    yW[:, :, 40:60] = yW[:, :, 0:20]
    yW[:, 1] = np.where(yW[:, 1] == 1, 0, yW[:, 1])   # node 1: no positives
    yW[:, 2] = 0                                       # node 2: padding only
    t = lambda a: torch.from_numpy(a).to(device)
    return t(v), t(XW), t(yW)


def _median_ms(fn, reps):
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def _nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def _exact(a, b, what):
    """Max |kernel - plain| over integer outputs; raises unless it is 0."""
    diff = (a.long() - b.long()).abs()
    err = int(diff.max()) if diff.numel() else 0
    if err:
        raise AssertionError(f"{what}: kernel and plain version disagree on "
                             f"{int((diff > 0).sum())} of {a.numel()} "
                             f"entries (max |diff| {err})")
    return err


def _card_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch import engine, kernels
    from repro_torch.core import datasets, geometry
    from repro_torch.engine import hotloop, median
    from repro_torch.kernels import _build

    card = _card_line()
    print(f"card: {card}")
    dev = torch.device("cuda")

    # -- 1. build ------------------------------------------------------------
    t0 = time.perf_counter()
    reports = _build.build_all()
    print(f"build: {time.perf_counter() - t0:.2f} s for "
          f"{sorted(reports) or 'nothing (already built)'}")
    for name, log in reports.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {name}: {line.strip()}")

    # -- 2. kernels against plain versions -----------------------------------
    cfg = SMOKE
    t0 = time.perf_counter()
    insts = smoke_instances(cfg["B"], cfg["n_per_node"], cfg["noisy_every"],
                            engine, datasets)
    data, s0, k, cap = engine.pack_instances(
        insts, n_angles=cfg["n_angles"], max_epochs=cfg["max_epochs"],
        device=dev)
    V = geometry.direction_grid(cfg["n_angles"], device=dev)
    print(f"setup: {cfg['B']} instances packed in "
          f"{time.perf_counter() - t0:.2f} s")

    # turn 1's inputs exactly as step gathers them: the first cut scan of
    # the sweep, at the full batch, with bounds built from shipped points
    s1 = median.step(data, V, s0, k=k, first_turn=True)
    ci = s1.turn % k
    g = median._gather_rows
    cut_args = (V, s1.dir_ok, g(s1.lo_w, ci), g(s1.hi_w, ci),
                g(data.X, ci), g(data.y, ci))
    W = hotloop.quantize_width(int(s1.w_fill.max()) + median.WIDTH_SLACK,
                               cap)
    v1 = V[kernels.median_cut_scores(*cut_args).argmax(dim=1)]
    ext_args = (v1, torch.cat([data.X, s1.wx[:, :, :W]], dim=2),
                torch.cat([data.y, s1.wy[:, :, :W]], dim=2))

    errs = {"median_cut_scores": 0, "median_extremes": 0}

    def hold_cut(args, what):
        errs["median_cut_scores"] = max(errs["median_cut_scores"], _exact(
            kernels.median_cut_scores(*args),
            kernels.median_cut_scores_plain(*args), what))

    def hold_extremes(args, what):
        for got, want in zip(kernels.median_extremes(*args),
                             kernels.median_extremes_plain(*args)):
            errs["median_extremes"] = max(errs["median_extremes"],
                                          _exact(got, want, what))

    hold_cut(cut_args, "cut scan, full batch")
    hold_extremes(ext_args, "extremes scan, full batch")
    for seed in range(3):
        hold_cut(crafted_cut_inputs(V, dev, seed), f"cut scan, ties {seed}")
        hold_extremes(crafted_extremes_inputs(dev, seed),
                      f"extremes scan, ties {seed}")
    print("kernels: integer-exact against the plain versions at the full-"
          "batch turn and on crafted ties")

    live_pts = int((cut_args[5] != 0).sum())
    m, B, n = cfg["n_angles"], cfg["B"], cut_args[4].shape[1]
    cut_bytes = _nbytes(*cut_args) + B * m * 4
    cut_ops = 3 * live_pts * m           # 2 multiplies + 1 add per test
    live_rows = int((ext_args[2] != 0).sum())
    ext_bytes = _nbytes(*ext_args) + 2 * B * k * 4
    ext_ops = 3 * live_rows
    rows = [
        dict(name="median_cut_scores", route="cuda",
             source="src/repro_torch/kernels/csrc/median_cut.cu",
             replaces="src/repro/kernels/median_cut.py:76",
             fn=lambda: kernels.median_cut_scores(*cut_args),
             plain=lambda: kernels.median_cut_scores_plain(*cut_args),
             bytes=cut_bytes, ops=cut_ops,
             shape=f"B={B} m={m} n={n}"),
        dict(name="median_extremes", route="cuda",
             source="src/repro_torch/kernels/csrc/median_extremes.cu",
             replaces="src/repro/kernels/support_margin.py:381",
             fn=lambda: kernels.median_extremes(*ext_args),
             plain=lambda: kernels.median_extremes_plain(*ext_args),
             bytes=ext_bytes, ops=ext_ops,
             shape=f"B={B} k={k} nW={ext_args[1].shape[2]}"),
    ]
    for r in rows:
        r["ms"] = _median_ms(r["fn"], 20)
        r["plain_ms"] = _median_ms(r["plain"], 3)
        by_bytes = r["bytes"] / PEAK_BYTES * 1e3
        by_ops = r["ops"] / PEAK_F32 * 1e3
        r["bound_ms"] = max(by_bytes, by_ops)
        r["bound_by"] = "bytes" if by_bytes >= by_ops else "operations"
        print(f"time {r['name']} at {r['shape']}: kernel {r['ms']:.4f} ms, "
              f"plain {r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
              f"({r['bound_by']}: {r['bytes']} bytes, {r['ops']} f32 ops)")

    # -- 3. the full-size sweep on the card ----------------------------------
    hotloop.KEY_LOG.clear()
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    res = engine.run_sweep(insts, n_angles=cfg["n_angles"],
                           max_epochs=cfg["max_epochs"], device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = kernels.launches()
    for name, c in counts.items():
        if c <= 0:
            raise AssertionError(f"the sweep never launched {name}")
    turns = len(hotloop.KEY_LOG)
    noisy = {i for i in range(cfg["B"]) if i % cfg["noisy_every"] == 0}
    conv = [r.converged for r in res]
    print(f"sweep: {cfg['B']} instances in {wall:.3f} s, {turns} turns, "
          f"{sum(conv)} converged, KEY_LOG size {turns}, launches {counts}, "
          f"tail widths {sorted({w for _, w, *_ in hotloop.KEY_LOG})[-3:]}")
    for i, (inst, r) in enumerate(zip(insts, res)):
        w, b = r.classifier.w, r.classifier.b
        if not (w.shape == (2,) and np.isfinite(w).all() and np.isfinite(b)):
            raise AssertionError(f"instance {i}: separator {w}, {b}")
        if i in noisy:
            if r.converged:
                raise AssertionError(f"noisy instance {i} converged")
            continue
        if not r.converged:
            raise AssertionError(f"separable instance {i} did not converge")
        X = np.concatenate([s[0] for s in inst.shards])
        y = np.concatenate([s[1] for s in inst.shards])
        err = float(np.mean(r.classifier.predict(X) != y))
        if err > inst.eps + 2.0 / len(y):
            raise AssertionError(f"instance {i}: error {err} > ε={inst.eps}")
    # the widest turn's extremes scan: the noisy tail at its final width
    tail = [insts[i] for i in sorted(noisy)]
    d_t, st, _, _ = engine.pack_instances(
        tail, n_angles=cfg["n_angles"], max_epochs=cfg["max_epochs"],
        device=dev)
    ft = median.run_hot(d_t, V, st, k=k, max_turns=k * cfg["max_epochs"],
                        cut_kernel=True, extremes_kernel=True)
    Wmax = hotloop.quantize_width(int(ft.w_fill.max()) + median.WIDTH_SLACK,
                                  cap)
    wide = (ft.h_v, torch.cat([d_t.X, ft.wx[:, :, :Wmax]], dim=2),
            torch.cat([d_t.y, ft.wy[:, :, :Wmax]], dim=2))
    hold_extremes(wide, "extremes scan, widest turn")
    print(f"time median_extremes at the widest turn (B={len(tail)} "
          f"nW={wide[1].shape[2]}): kernel "
          f"{_median_ms(lambda: kernels.median_extremes(*wide), 20):.4f} ms, "
          f"plain {_median_ms(lambda: kernels.median_extremes_plain(*wide), 5):.4f} ms")

    # -- 4. card against CPU -------------------------------------------------
    sub = insts[:SUBSET]
    opts = dict(n_angles=cfg["n_angles"], max_epochs=cfg["max_epochs"])
    on_card = engine.run_sweep(sub, device=dev, **opts)
    t0 = time.perf_counter()
    on_cpu = engine.run_sweep(sub, device="cpu", **opts)
    cpu_s = time.perf_counter() - t0
    bitwise = 0
    for i, (a, b) in enumerate(zip(on_card, on_cpu)):
        if (a.comm, a.rounds, a.converged) != (b.comm, b.rounds, b.converged):
            raise AssertionError(f"instance {i}: card {a.comm} {a.rounds} "
                                 f"{a.converged}, cpu {b.comm} {b.rounds} "
                                 f"{b.converged}")
        np.testing.assert_allclose(a.classifier.w, b.classifier.w, rtol=0,
                                   atol=1e-6)
        np.testing.assert_allclose(a.classifier.b, b.classifier.b, rtol=0,
                                   atol=1e-6)
        bitwise += bool(np.array_equal(a.classifier.w, b.classifier.w)
                        and a.classifier.b == b.classifier.b)
    print(f"card vs cpu: {SUBSET} instances ({sum(i in noisy for i in range(SUBSET))} "
          f"noisy), integer outputs exact, {bitwise}/{SUBSET} separators "
          f"bitwise equal (cpu run {cpu_s:.2f} s)")

    print(json.dumps({"kernels": [
        dict(name=r["name"], route=r["route"], source=r["source"],
             replaces=r["replaces"], launches=counts[r["name"]],
             max_abs_err=errs[r["name"]], ms=r["ms"], plain_ms=r["plain_ms"],
             bound_ms=r["bound_ms"], bound_by=r["bound_by"], library_ms=None)
        for r in rows]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
