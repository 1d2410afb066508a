"""Quickstart: the paper's protocols in five minutes, through the PyTorch
port.

Two nodes hold adversarially-partitioned labeled 2-D data (the paper's
Data3, the dataset where naive voting collapses to 50%); every protocol
from the paper runs and the table prints accuracy against communication,
the Table 2 story end to end.  The engine protocols (NAIVE, VOTING,
RANDOM, MAXMARG, MEDIAN) run on ``--device`` (the card by default).

Run:  PYTHONPATH=src python examples_torch/quickstart.py [--device cpu]
"""

import argparse

import numpy as np

from repro_torch.core import datasets
from repro_torch.core.protocols import baselines, one_way, two_way


def acc(clf, shards):
    X = np.concatenate([s[0] for s in shards])
    y = np.concatenate([s[1] for s in shards])
    return float(np.mean(clf.predict(X) == y))


def main(argv=None):
    """Print the tables; return their rows as ``(name, accuracy %, points,
    rounds)`` (rounds ``None`` for the 0-error protocols)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="where the engine protocols run (cuda or cpu)")
    args = ap.parse_args(argv)
    dev = args.device
    eps = 0.05
    shards = datasets.data3(n_per_node=500, k=2, seed=0)
    print(f"Data3: 2 nodes x 500 points, adversarial partition, eps={eps}\n")
    runs = [
        ("NAIVE (ship everything)", baselines.naive(shards, device=dev)),
        ("VOTING (local classifiers)", baselines.voting(shards, device=dev)),
        ("RANDOM (one-way eps-net, Thm 3.1)",
         baselines.random(shards, eps=eps, device=dev)),
        ("MAXMARG (two-way heuristic, Sec 4.4)",
         two_way.iterative_support_maxmarg(shards, eps=eps, device=dev)),
        ("MEDIAN (two-way, Thm 5.1: O(log 1/eps))",
         two_way.iterative_support_median(shards, eps=eps, device=dev)),
    ]
    rows = []
    print(f"{'method':45s} {'accuracy':>9s} {'points':>7s} {'rounds':>7s}")
    for name, r in runs:
        rows.append((name, 100 * acc(r.classifier, shards),
                     r.comm["points"], r.rounds))
        print(f"{name:45s} {rows[-1][1]:8.1f}% {r.comm['points']:7d} "
              f"{r.rounds:7d}")

    print("\n0-error protocols for simple classes (Sec 3):")
    th = one_way.threshold_protocol(datasets.threshold_instance(n=400, k=2))
    iv = one_way.interval_protocol(datasets.interval_instance(n=400, k=2))
    rc = one_way.rectangle_protocol(
        datasets.rectangle_instance(n=400, k=2, d=3))
    for name, r, sh in (
        ("thresholds (Lem 3.1)", th, datasets.threshold_instance(n=400, k=2)),
        ("intervals  (Lem 3.2)", iv, datasets.interval_instance(n=400, k=2)),
        ("rectangles (Thm 3.2)", rc,
         datasets.rectangle_instance(n=400, k=2, d=3)),
    ):
        rows.append((name, 100 * acc(r.classifier, sh), r.comm["points"],
                     None))
        print(f"  {name}: acc={rows[-1][1]:.1f}% "
              f"cost={r.comm['points']} points")
    return rows


if __name__ == "__main__":
    main()
