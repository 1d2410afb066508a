"""Distributed linear probe: the paper's protocol as a framework feature,
through the PyTorch port.

Scenario: k data-parallel workers each hold a disjoint shard of transformer
features (here: the reduced SmolLM configuration's embeddings of synthetic
token sequences) with labels, partitioned ADVERSARIALLY (each worker sees a
biased slice of feature space).  Learning a global linear head by shipping
raw features (NAIVE) costs O(n·d) floats; gradient averaging costs O(d)
floats per step × many steps; the paper's MEDIAN protocol gets an
ε-optimal head in O(log 1/ε) support points.  The model and the protocols
run on ``--device`` (the card by default).

Run:  PYTHONPATH=src python examples_torch/distributed_probe.py [--device cpu]
"""

import argparse

import numpy as np
import torch

import repro_torch.configs as C
from repro_torch.core.protocols import baselines, kparty
from repro_torch.models import model as M


def transformer_features(arch="smollm-135m", n=2000, seed=0,
                         device="cuda"):
    """Mean-pooled embeddings of synthetic token sequences (a cheap proxy
    feature map for the demo), as float64 on the host."""
    cfg = C.get_config(arch).reduced()
    lm = M.init_lm(cfg, seed, device=device)
    gen = torch.Generator().manual_seed(seed + 1)
    toks = torch.randint(0, cfg.vocab, (n, 32), generator=gen)
    emb = lm.embed[toks.to(lm.embed.device)]
    return emb.mean(dim=1).double().cpu().numpy()


def main(argv=None):
    """Print the table; return its rows as ``(method, accuracy %, points,
    bytes)``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="where the model and the protocols run (cuda or "
                         "cpu)")
    args = ap.parse_args(argv)
    dev = args.device
    k, eps = 4, 0.05
    feats = transformer_features(device=dev)
    rng = np.random.default_rng(0)
    proj = rng.normal(size=(feats.shape[1], 2))
    X = feats @ proj
    X = (X - X.mean(0)) / (X.std(0) + 1e-9)
    w_true = rng.normal(size=2)
    margin = X @ w_true
    keep = np.abs(margin) > 0.15
    X, margin = X[keep], margin[keep]
    y = np.where(margin > 0, 1, -1).astype(np.int32)

    # adversarial partition: each worker gets one angular sector
    ang = np.arctan2(X[:, 1], X[:, 0])
    order = np.argsort(ang)
    shards = [(X[c], y[c]) for c in np.array_split(order, k)]
    n_total = sum(len(s[1]) for s in shards)
    print(f"{k} workers, {n_total} labeled transformer-feature points, "
          f"adversarial sector partition, eps={eps}\n")

    naive = baselines.naive(shards, device=dev)
    vote = baselines.voting(shards, device=dev)
    rand = baselines.random(shards, eps=eps, device=dev)
    med = kparty.iterative_support_kparty(shards, eps=eps,
                                          selector="median", device=dev)
    Xa = np.concatenate([s[0] for s in shards])
    ya = np.concatenate([s[1] for s in shards])

    rows = []
    print(f"{'method':28s} {'accuracy':>9s} {'points':>7s} {'bytes':>10s}")
    for name, r in (("NAIVE", naive), ("VOTING", vote), ("RANDOM", rand),
                    ("MEDIAN (k-party two-way)", med)):
        rows.append((name, 100 * float(np.mean(r.classifier.predict(Xa)
                                                == ya)),
                     r.comm["points"], r.comm["bytes"]))
        print(f"{name:28s} {rows[-1][1]:8.1f}% {r.comm['points']:7d} "
              f"{r.comm['bytes']:10d}")

    # compare against what gradient sync would cost for the same head
    d = X.shape[1]
    steps, bytes_per_step = 200, k * d * 4 * 2  # psum grad + bcast params
    print(f"\n(gradient-averaging reference: {steps} steps x "
          f"{bytes_per_step}B = {steps * bytes_per_step} bytes for one "
          f"linear head)")
    return rows


if __name__ == "__main__":
    main()
