"""Geometric primitives on tensors (counterpart of ``repro.core.geometry``).

Every projection that feeds a strict comparison is written out as
``(v0*x0) + (v1*x1)`` (left to right over d), rounded after each op, the
way the JAX engine's inline path forms it.  A dot, ``matmul`` or an FMA
rounds differently and flips ties where a point's projection is compared
with a bound built from that same point.
"""

from __future__ import annotations

import math

import torch

from repro_torch import _device


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
