"""The paper's synthetic data sets (arXiv:1202.6078 §8, Table 2) and its
label noise (§8.2), in NumPy: a frozen copy of ``data1``, ``data2``,
``data3`` and ``add_label_noise`` as ``repro_torch.core.datasets`` has
them, so the benchmark's inputs do not move with the program.

``seed`` is anything ``np.random.default_rng`` takes (an int or a list
of ints)."""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

Shard = Tuple[np.ndarray, np.ndarray]


def _blob(rng, center, n, scale=0.25):
    return rng.normal(0.0, scale, size=(n, len(center))) + np.asarray(center)


def _box(rng, lo, hi, n):
    lo = np.asarray(lo, dtype=np.float64)
    hi = np.asarray(hi, dtype=np.float64)
    return rng.uniform(lo, hi, size=(n, len(lo)))


def _labels(half):
    return np.concatenate([np.ones(half), -np.ones(half)]).astype(np.int32)


def data1(n_per_node: int = 500, k: int = 2, seed=0) -> List[Shard]:
    """Easy: iid split of two well-separated blobs (global separator x=0)."""
    rng = np.random.default_rng(seed)
    half = n_per_node // 2
    shards = []
    for _ in range(k):
        Xp = _blob(rng, (-1.5, 0.0), half)
        Xn = _blob(rng, (+1.5, 0.0), half)
        shards.append((np.concatenate([Xp, Xn]), _labels(half)))
    return shards


def data2(n_per_node: int = 500, k: int = 2, seed=1) -> List[Shard]:
    """Nodes occupy disjoint y-bands of one separable set (separator x=0)."""
    rng = np.random.default_rng(seed)
    half = n_per_node // 2
    shards = []
    for i in range(k):
        y0 = -2.0 + 4.0 * i / max(k - 1, 1)
        Xp = _box(rng, (-2.5, y0 - 0.4), (-0.5, y0 + 0.4), half)
        Xn = _box(rng, (0.5, y0 - 0.4), (2.5, y0 + 0.4), half)
        shards.append((np.concatenate([Xp, Xn]), _labels(half)))
    return shards


def data3(n_per_node: int = 500, k: int = 2, seed=2) -> List[Shard]:
    """The voting-killer: global separator y = x/2, each node in a narrow
    x-column, so local separators mislead a vote."""
    rng = np.random.default_rng(seed)
    half = n_per_node // 2
    shards = []
    xs = np.linspace(-2.5, 2.5, k)
    for i in range(k):
        cx = xs[i]
        ly = cx / 2.0
        Xp = _box(rng, (cx - 0.3, ly + 0.5), (cx + 0.3, ly + 1.0), half)
        Xn = _box(rng, (cx - 0.3, ly - 1.0), (cx + 0.3, ly - 0.5), half)
        shards.append((np.concatenate([Xp, Xn]), _labels(half)))
    return shards


def add_label_noise(shards: List[Shard], rate: float, seed=11) -> List[Shard]:
    """Flip a ``rate`` fraction of labels per shard (paper §8.2)."""
    rng = np.random.default_rng(seed)
    out = []
    for X, y in shards:
        y2 = y.copy()
        n_flip = int(round(rate * len(y)))
        idx = rng.choice(len(y), size=n_flip, replace=False)
        y2[idx] = -y2[idx]
        out.append((X, y2))
    return out


GENERATORS = {"data1": data1, "data2": data2, "data3": data3}
