"""Geometric primitives (counterpart of ``repro.core.geometry``).

Control-plane geometry (convex hulls, medians) is host numpy, copied from
the JAX package: protocol rounds are tiny.  The data-plane functions take
tensors; :func:`consistent_threshold_ranges` and :func:`uncertain_mask`
launch the B=1 ranges and set-of-uncertainty kernels for tensors on the
card (``kernels.threshold_ranges_one`` / ``uncertain_mask_one``) and take
their plain versions on the CPU.

Every projection that feeds a strict comparison is written out as
``(v0*x0) + (v1*x1)`` (left to right over d), rounded after each op, the
way the JAX engine's inline path forms it.  A dot, ``matmul`` or an FMA
rounds differently and flips ties where a point's projection is compared
with a bound built from that same point.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

from repro_torch import _device


# ---------------------------------------------------------------------------
# Convex hulls (2D, host-side; monotone chain)
# ---------------------------------------------------------------------------

def convex_hull_2d(points: np.ndarray) -> np.ndarray:
    """Indices of the convex hull of 2-D ``points`` in counter-clockwise order.

    Andrew's monotone chain; O(n log n).  Degenerate inputs (<=2 points or
    collinear) return all unique points.
    """
    pts = np.asarray(points, dtype=np.float64)
    n = pts.shape[0]
    if n == 0:
        return np.zeros((0,), dtype=np.int64)
    order = np.lexsort((pts[:, 1], pts[:, 0]))
    pts_sorted = pts[order]

    def cross(o, a, b):
        return (a[0] - o[0]) * (b[1] - o[1]) - (a[1] - o[1]) * (b[0] - o[0])

    if n < 3:
        return order

    lower: list = []
    for i in range(n):
        while len(lower) >= 2 and cross(pts_sorted[lower[-2]], pts_sorted[lower[-1]], pts_sorted[i]) <= 0:
            lower.pop()
        lower.append(i)
    upper: list = []
    for i in range(n - 1, -1, -1):
        while len(upper) >= 2 and cross(pts_sorted[upper[-2]], pts_sorted[upper[-1]], pts_sorted[i]) <= 0:
            upper.pop()
        upper.append(i)
    hull_sorted = lower[:-1] + upper[:-1]
    if not hull_sorted:  # fully collinear
        hull_sorted = [0, n - 1]
    return order[np.asarray(hull_sorted, dtype=np.int64)]


def hull_edges(points: np.ndarray, hull_idx: np.ndarray) -> np.ndarray:
    """(m, 2, 2) array of hull edge segments in CCW order."""
    h = points[hull_idx]
    return np.stack([h, np.roll(h, -1, axis=0)], axis=1)


def edge_normals(edges: np.ndarray) -> np.ndarray:
    """Outward normals of CCW hull edges, unit length. edges: (m,2,2)."""
    d = edges[:, 1] - edges[:, 0]
    n = np.stack([d[:, 1], -d[:, 0]], axis=-1)  # rotate -90deg: outward for CCW
    norm = np.linalg.norm(n, axis=-1, keepdims=True)
    norm = np.where(norm == 0, 1.0, norm)
    return n / norm


def project_to_hull_boundary(points: np.ndarray, edges: np.ndarray) -> np.ndarray:
    """For each point return the index of the nearest hull edge.

    Implements the MEDIAN subroutine's 'project U_A onto ∂P_A' step (paper
    Alg. 2, line 3): each uncertain point is charged to the closest boundary
    edge, producing the per-edge weights used for the weighted median.
    """
    if len(points) == 0:
        return np.zeros((0,), dtype=np.int64)
    a = edges[:, 0][None, :, :]  # (1, m, 2)
    b = edges[:, 1][None, :, :]
    p = np.asarray(points)[:, None, :]  # (n, 1, 2)
    ab = b - a
    denom = np.maximum((ab * ab).sum(-1), 1e-30)
    t = np.clip(((p - a) * ab).sum(-1) / denom, 0.0, 1.0)
    proj = a + t[..., None] * ab
    dist = np.linalg.norm(p - proj, axis=-1)  # (n, m)
    return np.argmin(dist, axis=1)


def weighted_median_index(weights: np.ndarray) -> int:
    """Index of the weighted median item (first index where cumsum >= half)."""
    w = np.asarray(weights, dtype=np.float64)
    total = w.sum()
    if total <= 0:
        return 0
    c = np.cumsum(w)
    return int(np.searchsorted(c, total / 2.0))


# ---------------------------------------------------------------------------
# Projections and margins (tensors)
# ---------------------------------------------------------------------------


def project(V: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    """(m, d) × (..., n, d) -> (..., m, n): every point on every direction,
    ``sum_i V[:, i] * X[..., i]`` left to right over d, one rounding per
    multiply and per add."""
    p = V[:, None, 0] * X[..., None, :, 0]
    for i in range(1, V.shape[1]):
        p = p + V[:, None, i] * X[..., None, :, i]
    return p


def project_each(X: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """(B, ..., d) × (B, d) -> (B, ...): each instance's points on its own
    direction, rounded as :func:`project`."""
    vb = v.reshape(v.shape[0:1] + (1,) * (X.ndim - 2) + v.shape[1:])
    p = X[..., 0] * vb[..., 0]
    for i in range(1, X.shape[-1]):
        p = p + X[..., i] * vb[..., i]
    return p


def decide(X: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(B, ..., d) × (B, d) × (B,) -> (B, ...): each instance's decision
    values ``sum_i x_i w_i + b``, left to right over d and then the offset,
    rounded as :func:`project` — the order the MAXMARG solver, its kernels
    and its step form every margin in."""
    wb = w.reshape(w.shape[0:1] + (1,) * (X.ndim - 2) + w.shape[1:])
    dec = X[..., 0] * wb[..., 0]
    for i in range(1, X.shape[-1]):
        dec = dec + X[..., i] * wb[..., i]
    return dec + b.reshape(b.shape + (1,) * (X.ndim - 2))


def signed_margins(w: torch.Tensor, b, X: torch.Tensor,
                   y: torch.Tensor) -> torch.Tensor:
    """y * (X @ w + b) — positive iff correctly classified."""
    return y * (X @ w + b)


def classification_error(w: torch.Tensor, b, X: torch.Tensor,
                         y: torch.Tensor) -> torch.Tensor:
    """Fraction of misclassified points (ties count as errors)."""
    return (signed_margins(w, b, X, y) <= 0).float().mean()


def direction_grid(n_angles: int, device="cuda") -> torch.Tensor:
    """Unit vectors covering S^1: (n_angles, 2) f32.

    θ is the f32 ``linspace(0, 2π, n_angles, endpoint=False)`` exactly as
    the JAX package forms it; cos/sin are taken in float64 on the host and
    rounded once to f32, then moved to ``device``.  The grid is therefore
    the same on the card and on the CPU; it is within 1 ulp of XLA's f32
    cos/sin (they differ on 4 of the 512 entries at 256 angles).
    """
    dev = _device.resolve(device)
    theta = torch.linspace(0.0, 2.0 * math.pi, n_angles + 1,
                           dtype=torch.float32)[:-1].double()
    V = torch.stack([torch.cos(theta), torch.sin(theta)], dim=-1)
    return V.float().to(dev)


def _scan_inputs(V, Xw, yw):
    """The ranges scan's operand types: f32 contiguous directions and
    points, int32 labels."""
    return (V.to(torch.float32).contiguous(),
            Xw.to(torch.float32).contiguous(),
            yw.to(torch.int32).contiguous())


def consistent_threshold_ranges(
    V: torch.Tensor, Xw: torch.Tensor, yw: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-direction interval of thresholds consistent with transcript W.

    Classifier convention: predict +1 iff v·x < t.  For direction v the
    consistent thresholds are ( max_{+} v·x , min_{-} v·x ); the interval is
    empty (lo >= hi) iff W is not separable along v.  Label-0 rows
    constrain neither side.

    V: (m, d) unit directions; Xw: (n, d) transcript points; yw: (n,) ±1
    (0 = padding), all on one device.  Returns (lo, hi), each (m,) f32.
    With an empty transcript lo=-inf, hi=+inf.  A CUDA tensor launches
    ``kernels.threshold_ranges_one``; a CPU tensor takes the plain version.
    Projections round once per operation (:func:`project`), where the JAX
    package's ``V @ Xw.T`` may fuse them.
    """
    from repro_torch import kernels

    V, Xw, yw = _scan_inputs(V, Xw, yw)
    if Xw.shape[0] == 0:
        m = V.shape[0]
        return (torch.full((m,), -math.inf, device=V.device),
                torch.full((m,), math.inf, device=V.device))
    return kernels.threshold_ranges_one(V, Xw, yw)


def uncertain_mask(
    V: torch.Tensor,
    dir_ok: torch.Tensor,
    Xw: torch.Tensor,
    yw: torch.Tensor,
    X: torch.Tensor,
    y: torch.Tensor,
) -> torch.Tensor:
    """Set of uncertainty: which of (X, y) can a transcript-consistent
    classifier (direction allowed by ``dir_ok``) still misclassify?

    Convention: predict +1 iff v·x < t, consistent t ∈ (lo, hi).  A positive
    point q is misclassified by some consistent classifier along v iff
    v·q > lo; any other point iff v·q < hi.  Returns a bool (n,) mask — the
    SOU of paper §4.1.  The ranges come from
    :func:`consistent_threshold_ranges`; the membership launches
    ``kernels.uncertain_mask_one`` for CUDA tensors and takes its plain
    version on the CPU.
    """
    from repro_torch import kernels

    lo, hi = consistent_threshold_ranges(V, Xw, yw)
    V, X, y = _scan_inputs(V, X, y)
    return kernels.uncertain_mask_one(V, dir_ok.to(torch.bool).contiguous(),
                                      lo, hi, X, y)
