"""Synthetic datasets reproducing the paper's experimental setup (§7).

Data1/Data2/Data3 follow Figure 3/4 qualitatively: 500 points per node
(250 positive / 250 negative), noiseless (a perfect linear separator exists
on the union), with partitions ranging from benign (Data1: iid split) to
adversarial (Data3: each node's local max-margin classifier badly misleads
voting — the paper's 50%-accuracy voting failure case).

Also provides: threshold/interval/rectangle instances, the d-dimensional
extension used for Table 3, and the Appendix-A indexing construction for the
one-way Ω(1/ε) lower bound.
"""

from __future__ import annotations

import math
from typing import List, Tuple

import numpy as np

Shard = Tuple[np.ndarray, np.ndarray]


def _blob(rng, center, n, scale=0.25):
    return rng.normal(0.0, scale, size=(n, len(center))) + np.asarray(center)


def _box(rng, lo, hi, n):
    lo = np.asarray(lo, dtype=np.float64)
    hi = np.asarray(hi, dtype=np.float64)
    return rng.uniform(lo, hi, size=(n, len(lo)))


def data1(n_per_node: int = 500, k: int = 2, seed: int = 0) -> List[Shard]:
    """Easy: iid split of two well-separated blobs (global separator x=0)."""
    rng = np.random.default_rng(seed)
    shards = []
    half = n_per_node // 2
    for _ in range(k):
        Xp = _blob(rng, (-1.5, 0.0), half)
        Xn = _blob(rng, (+1.5, 0.0), half)
        X = np.concatenate([Xp, Xn])
        y = np.concatenate([np.ones(half), -np.ones(half)]).astype(np.int32)
        shards.append((X, y))
    return shards


def data2(n_per_node: int = 500, k: int = 2, seed: int = 1) -> List[Shard]:
    """Adversarial-by-region: nodes occupy disjoint y-bands of one globally
    separable set (separator x=0); local classifiers still roughly agree."""
    rng = np.random.default_rng(seed)
    shards = []
    half = n_per_node // 2
    for i in range(k):
        y0 = -2.0 + 4.0 * i / max(k - 1, 1)
        Xp = _box(rng, (-2.5, y0 - 0.4), (-0.5, y0 + 0.4), half)
        Xn = _box(rng, (0.5, y0 - 0.4), (2.5, y0 + 0.4), half)
        X = np.concatenate([Xp, Xn])
        y = np.concatenate([np.ones(half), -np.ones(half)]).astype(np.int32)
        shards.append((X, y))
    return shards


def data3(n_per_node: int = 500, k: int = 2, seed: int = 2) -> List[Shard]:
    """The voting-killer (paper Data3, Table 2: VOTING = 50%).

    Global separator is the slanted line y = x/2 (positives above).  Node i
    sits in a narrow x-column, so its *local* max-margin separator is nearly
    horizontal at its own column's height — each local classifier is ~50%
    wrong on the other nodes' points, and majority voting collapses.
    """
    rng = np.random.default_rng(seed)
    shards = []
    half = n_per_node // 2
    xs = np.linspace(-2.5, 2.5, k)
    for i in range(k):
        cx = xs[i]
        ly = cx / 2.0  # global line height at this column
        Xp = _box(rng, (cx - 0.3, ly + 0.5), (cx + 0.3, ly + 1.0), half)
        Xn = _box(rng, (cx - 0.3, ly - 1.0), (cx + 0.3, ly - 0.5), half)
        X = np.concatenate([Xp, Xn])
        y = np.concatenate([np.ones(half), -np.ones(half)]).astype(np.int32)
        shards.append((X, y))
    return shards


def data_mixed_hardness(n_per_node: int = 100, k: int = 4, seed: int = 0,
                        gap: float = 0.15, n_hard: int = 2) -> List[Shard]:
    """k-party partition with heterogeneous hardness: ``n_hard`` nodes hold
    tight near-margin bands around the slanted separator y = x/2 in their
    own x-columns (driving a multi-epoch MAXMARG support exchange), the
    rest hold far easy blobs.  The regime the per-node warm carries target:
    an easy node verifies a mid-epoch proposal clean, adopts it, and its
    next refit latches through the warm polish."""
    rng = np.random.default_rng(seed)
    half = n_per_node // 2
    xs = np.linspace(-2.0, 2.0, k)
    shards = []
    for i in range(k):
        cx, ly = xs[i], xs[i] / 2.0
        if i < n_hard:
            Xp = rng.uniform((cx - 0.3, ly + gap), (cx + 0.3, ly + 2.5 * gap),
                             size=(half, 2))
            Xn = rng.uniform((cx - 0.3, ly - 2.5 * gap), (cx + 0.3, ly - gap),
                             size=(half, 2))
        else:
            Xp = rng.uniform((cx - 0.3, ly + 1.2), (cx + 0.3, ly + 2.0),
                             size=(half, 2))
            Xn = rng.uniform((cx - 0.3, ly - 2.0), (cx + 0.3, ly - 1.2),
                             size=(half, 2))
        X = np.concatenate([Xp, Xn])
        y = np.concatenate([np.ones(half), -np.ones(half)]).astype(np.int32)
        shards.append((X, y))
    return shards


def data_highd(n_per_node: int = 200, k: int = 2, d: int = 16, seed: int = 0,
               margin: float = 0.2, scale: float = 1.0) -> List[Shard]:
    """Separable Gaussians in R^d with a controllable geometric margin —
    the d ≫ 2 regime the tiled Pegasos solver targets (d ∈ {16, 64, 256}
    in the kernel bench; any d ≥ 2 works).

    Points are iid N(0, scale²·I) projected out of a ``margin``-wide slab
    around a random unit separator w*: each point is shifted along ±w* so
    its distance to the hyperplane is at least ``margin`` on its own side.
    Labels are the side of w*.  The margin is *geometric* (units of the
    feature space), so ``margin → 0`` produces near-degenerate instances
    whose support set is decided at float precision — the knob the
    warm-latch adversarial tests turn.  Shards split round-robin so every
    node sees both classes."""
    if d < 2:
        raise ValueError("data_highd needs d >= 2")
    rng = np.random.default_rng(seed)
    wstar = rng.standard_normal(d)
    wstar /= np.linalg.norm(wstar)
    n = n_per_node * k
    X = rng.normal(0.0, scale, size=(n, d))
    proj = X @ wstar
    y = np.where(proj >= 0.0, 1, -1).astype(np.int32)
    # push each point out of the slab: along-w* distance becomes
    # sign(proj)·(margin + |proj|) ≥ margin, leaving the orthogonal
    # complement untouched (labels unchanged by construction)
    X = X + np.outer(y * margin, wstar)
    return [(X[i::k], y[i::k]) for i in range(k)]


def lift_dim(shards: List[Shard], d: int, seed: int = 7, noise: float = 0.05) -> List[Shard]:
    """Embed 2-D shards into R^d (Table 3's high-dimensional variant): the
    informative structure stays in the first two coordinates, the remaining
    d-2 are small iid noise, so the union stays linearly separable."""
    rng = np.random.default_rng(seed)
    out = []
    for X, y in shards:
        pad = rng.normal(0.0, noise, size=(X.shape[0], d - 2))
        out.append((np.concatenate([X, pad], axis=1), y))
    return out


# ---------------------------------------------------------------------------
# Simple geometric hypothesis classes
# ---------------------------------------------------------------------------

def threshold_instance(n: int = 400, k: int = 2, t: float = 0.37, seed: int = 3) -> List[Shard]:
    """1-D data labeled +1 iff x < t; arbitrary (sorted-adversarial) split."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1, 1, size=(n,))
    y = np.where(x < t, 1, -1).astype(np.int32)
    order = np.argsort(x)  # adversarial: node 0 gets the left chunk, etc.
    chunks = np.array_split(order, k)
    return [(x[c].reshape(-1, 1), y[c]) for c in chunks]


def interval_instance(n: int = 400, k: int = 2, a: float = -0.4, b: float = 0.5, seed: int = 4) -> List[Shard]:
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1, 1, size=(n,))
    y = np.where((x >= a) & (x <= b), 1, -1).astype(np.int32)
    idx = rng.permutation(n)
    chunks = np.array_split(idx, k)
    return [(x[c].reshape(-1, 1), y[c]) for c in chunks]


def rectangle_instance(n: int = 600, k: int = 2, d: int = 3, seed: int = 5) -> List[Shard]:
    """Points in [-1,1]^d labeled +1 iff inside a random rectangle."""
    rng = np.random.default_rng(seed)
    lo = rng.uniform(-0.6, -0.1, size=(d,))
    hi = rng.uniform(0.1, 0.6, size=(d,))
    X = rng.uniform(-1, 1, size=(n, d))
    inside = np.all((X >= lo) & (X <= hi), axis=1)
    # ensure both classes present
    y = np.where(inside, 1, -1).astype(np.int32)
    idx = rng.permutation(n)
    chunks = np.array_split(idx, k)
    return [(X[c], y[c]) for c in chunks]


# ---------------------------------------------------------------------------
# Appendix A: indexing construction for the one-way Ω(1/ε) lower bound
# ---------------------------------------------------------------------------

def indexing_instance(eps: float, seed: int = 6, radius: float = 10.0) -> Tuple[Shard, Shard, np.ndarray]:
    """A holds 1/(2ε) near-circle negative point *pairs* (each pair in one of
    two configurations = one index bit); B holds a single positive point b+
    aimed at a random pair.  Returns (shard_A, shard_B, bits).

    Any ε-error classifier must effectively know the bit of the targeted
    pair, so any one-way protocol that succeeds on all instances carries
    Ω(1/ε) bits (paper Thm A.1).
    """
    rng = np.random.default_rng(seed)
    n_pairs = max(2, int(round(1.0 / (2 * eps))))
    bits = rng.integers(0, 2, size=(n_pairs,))
    thetas = 2 * np.pi * (np.arange(n_pairs) + 0.25) / n_pairs
    delta_t = (2 * np.pi / n_pairs) * 0.12  # angular gap inside a pair
    dr = 0.02 * radius                      # radial in/out perturbation
    pts = []
    for j, th in enumerate(thetas):
        # left point at th - delta, right at th + delta (clockwise order)
        for side, sign in (("L", -1.0), ("R", +1.0)):
            ang = th + sign * delta_t
            inside = (bits[j] == 0) == (side == "L")  # case1: L in, R out
            r = radius - dr if inside else radius + dr
            pts.append((r * math.cos(ang), r * math.sin(ang)))
    XA = np.asarray(pts)
    yA = -np.ones(len(pts), dtype=np.int32)
    tgt = int(rng.integers(0, n_pairs))
    th = thetas[tgt]
    bp = np.asarray([[(radius - 2.2 * dr) * math.cos(th), (radius - 2.2 * dr) * math.sin(th)]])
    yB = np.ones(1, dtype=np.int32)
    return (XA, yA), (bp, yB), bits


def add_label_noise(shards: List[Shard], rate: float, seed: int = 11) -> List[Shard]:
    """Flip a ``rate`` fraction of labels per shard (paper §8.2 noisy setting)."""
    rng = np.random.default_rng(seed)
    out = []
    for X, y in shards:
        y2 = y.copy()
        n_flip = int(round(rate * len(y)))
        idx = rng.choice(len(y), size=n_flip, replace=False)
        y2[idx] = -y2[idx]
        out.append((X, y2))
    return out
