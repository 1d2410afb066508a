"""Sampling utilities: reservoir sampling (Vitter 1985) and ε-net sizes.

Used by the one-way k-party sampling protocol (paper Thm 6.1): player P_i
maintains a reservoir R_i of size s_ε over ∪_{j<=i} D_j and forwards it down
the chain.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np

# The ε-net leading constant used by *every* RANDOM entry point
# (one_way.random_sampling, baselines.random, engine.oneway "sampling").
# c = 1.0 is the paper's literal Table-2 size (d/ε)·log(d/ε); keeping one
# shared constant makes RANDOM's cost column reproducible from any API —
# the entry points used to disagree (0.35 vs 1.0), which silently changed
# both the sample cost and the achieved error depending on the call site.
EPSILON_NET_C = 1.0


def epsilon_net_size(eps: float, vc_dim: int, c: float = EPSILON_NET_C) -> int:
    """s_ε = O((ν/ε) log(ν/ε)) — paper Thm 3.1 (noiseless ε-net bound)."""
    assert 0 < eps < 1
    r = vc_dim / eps
    return max(1, int(math.ceil(c * r * max(1.0, math.log(max(r, 2.0))))))


def epsilon_sample_size(eps: float, vc_dim: int, c: float = 0.5) -> int:
    """s = O(ν/ε²) — the noisy-setting ε-sample bound (paper §3/§8)."""
    assert 0 < eps < 1
    return max(1, int(math.ceil(c * vc_dim / (eps * eps))))


class Reservoir:
    """Classic reservoir sampler over a stream of labeled points.

    Supports merging a downstream node's data into an upstream reservoir with
    the correct inclusion probabilities (weighted by stream position), which
    is what the chain protocol needs.
    """

    def __init__(self, capacity: int, dim: int, rng: Optional[np.random.Generator] = None):
        self.capacity = int(capacity)
        self.X = np.zeros((capacity, dim))
        self.y = np.zeros((capacity,), dtype=np.int32)
        self.seen = 0
        self.filled = 0
        self.rng = rng or np.random.default_rng(0)

    def add(self, x: np.ndarray, label: int) -> None:
        self.seen += 1
        if self.filled < self.capacity:
            self.X[self.filled] = x
            self.y[self.filled] = label
            self.filled += 1
            return
        j = self.rng.integers(0, self.seen)
        if j < self.capacity:
            self.X[j] = x
            self.y[j] = label

    def add_batch(self, X: np.ndarray, y: np.ndarray) -> None:
        """Vectorized ingest of a whole shard — one RNG draw and two fancy
        assignments instead of O(n) Python-level ``add`` calls.

        Identical process to repeated :meth:`add`: the item at global stream
        position t draws j ~ U[0, t) and replaces slot j iff j < capacity.
        Later items overwrite earlier ones on slot collisions (numpy fancy
        assignment keeps the last write), matching sequential order, so
        inclusion probabilities are exactly Vitter's k/t.
        """
        X = np.atleast_2d(np.asarray(X, dtype=np.float64))
        y = np.atleast_1d(np.asarray(y))
        n = X.shape[0]
        if n == 0:
            return
        start = 0
        if self.filled < self.capacity:
            take = min(self.capacity - self.filled, n)
            self.X[self.filled:self.filled + take] = X[:take]
            self.y[self.filled:self.filled + take] = y[:take]
            self.filled += take
            self.seen += take
            start = take
        rest = n - start
        if rest == 0:
            return
        positions = self.seen + 1 + np.arange(rest)   # 1-based stream counts
        j = self.rng.integers(0, positions)           # j ~ U[0, t) per item
        hit = j < self.capacity
        self.X[j[hit]] = X[start:][hit]
        self.y[j[hit]] = y[start:][hit]
        self.seen += rest

    def sample(self) -> Tuple[np.ndarray, np.ndarray]:
        return self.X[: self.filled].copy(), self.y[: self.filled].copy()

    def sample_padded(self, n_pad: int) -> Tuple[np.ndarray, np.ndarray]:
        """Snapshot padded to exactly ``n_pad`` rows with the engine's
        label-0 convention (zero rows are inert in every masked reduction).

        The streaming session pool admits sessions at *pinned* shard shapes
        so the compacted dispatch's compile-cache keys never move
        (``engine/session_pool``): each ingest node keeps a reservoir of
        capacity ≤ n_pad and admission takes this fixed-shape snapshot, not
        the ragged :meth:`sample` one.
        """
        if self.capacity > n_pad:
            raise ValueError(
                f"reservoir capacity {self.capacity} exceeds the pool's "
                f"pinned shard shape n_pad={n_pad}")
        X = np.zeros((n_pad, self.X.shape[1]))
        y = np.zeros((n_pad,), np.int32)
        X[: self.filled] = self.X[: self.filled]
        y[: self.filled] = self.y[: self.filled]
        return X, y
