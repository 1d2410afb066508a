#!/usr/bin/env python3
"""Walls of the port's host-bound protocol sweeps on one card, so that two
trees of the port can be compared within one call.

    PYTHONPATH=<tree>/src python scripts/host_walls.py --tag <name>

The ``repro_torch`` first on ``PYTHONPATH`` is the one measured; the
instances are ``chip_smoke.py``'s (this checkout's).  Three sweeps, each
run once to build and warm, then ``REPS`` times timed (host wall, the
card synchronised before and after):

* the MEDIAN sweep of ``chip_smoke.py`` phase 3 (B=3072, unsharded);
* the same sweep over 4 logical shards on the card (phase 18a);
* MAXMARG's first bucket (k2_d2, B=1152) over 4 logical shards (18a).

Where the tree has ``repro_torch.analysis.autotune.plan_for``, the host
time of one lookup (the call every tuned wrapper makes when given no
plan) is timed too.  Prints one JSON line with the walls in seconds, the
tuned wrappers' launches a sweep and the card.
"""

import argparse
import importlib.util
import json
import os
import statistics
import subprocess
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPS = 3
TUNED = ("median_extremes", "maxmarg_turn_scan", "pegasos_stage",
         "threshold_ranges")


def _smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tag", required=True, help="name of the tree")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        raise RuntimeError("host_walls times sweeps on a CUDA card")
    import repro_torch
    from repro_torch import engine, kernels
    from repro_torch.core import datasets
    from repro_torch.kernels import _build
    from repro_torch.launch.mesh import make_data_mesh

    smoke = _smoke()
    _build.build_all()
    dev = torch.device("cuda")
    cfg = smoke.SMOKE
    med = smoke.smoke_instances(cfg["B"], cfg["n_per_node"],
                                cfg["noisy_every"], engine, datasets)
    mm = smoke.maxmarg_buckets(datasets, engine)[0][1]
    mopts = dict(n_angles=cfg["n_angles"], max_epochs=cfg["max_epochs"])
    mesh4 = make_data_mesh(device=[dev] * 4)
    sweeps = {
        "median_b3072": lambda: engine.run_sweep(med, device=dev, **mopts),
        "median_4_shards": lambda: engine.run_sweep(
            med, mesh=mesh4, device=dev, **mopts),
        "maxmarg_k2_d2_4_shards": lambda: engine.run_sweep(
            mm, mesh=mesh4, device=dev, **smoke.MAXMARG),
    }
    walls, launches = {}, {}
    for name, fn in sweeps.items():
        fn()
        walls[name] = []
        for _ in range(REPS):
            torch.cuda.synchronize()
            kernels.reset_launches()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            walls[name].append(time.perf_counter() - t0)
        counts = kernels.launches()
        launches[name] = {k: counts[k] for k in TUNED if k in counts}
        print(f"{args.tag} {name}: walls {walls[name]} s, median "
              f"{statistics.median(walls[name])} s, tuned launches "
              f"{launches[name]}", flush=True)

    lookup_us = None
    try:
        from repro_torch.analysis import autotune
    except ImportError:      # a tree from before the tuner
        autotune = None
    if autotune is not None:
        n = 100000
        t0 = time.perf_counter()
        for _ in range(n):
            autotune.plan_for("pegasos_stage", dev, 1152, 1008, 2)
        lookup_us = (time.perf_counter() - t0) / n * 1e6
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    print(json.dumps({"tag": args.tag, "tree": os.path.dirname(
        os.path.dirname(repro_torch.__file__)), "walls_s": walls,
        "tuned_launches": launches, "plan_for_us": lookup_us,
        "card": card}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
