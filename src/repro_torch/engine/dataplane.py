"""The selectors' per-turn scans and the bulk scans over sweep state,
routed to the port's kernels (counterpart of ``repro.engine.dataplane``).

MEDIAN: ``median_cut(V, dir_ok, lo, hi, X, y)`` gives the batched
median-cut scores (int32 (B, m), -1 at disallowed cuts) that the
coordinator argmaxes; ``median_extremes_segments(v, X, y, wx, wy, W)``
the per-node extreme rows of stage 5 over the own rows and the transcripts
at the hot loop's fill-capped width, each read where it lies (the
one-segment ``median_extremes(v, XW, yW)`` gives ``(i_p, i_q)`` alone).
MAXMARG: ``maxmarg_turn_scan(w, b, K, yK, X, y, ...)`` gives the support
ranks, per-node error counts and most-violated ranks of a refit
proposal; ``pegasos_stage(X, y, nv, w, b, lam, found, w_best, b_best, ...)``
runs one λ stage of the refit solver with its first-0-error latch.

Bulk scans (off the turn loops): :func:`ranges` rescans transcripts into
consistent-threshold intervals — the oracle for the ranges MEDIAN keeps
at append time — and :func:`uncertain` gives set-of-uncertainty membership
(paper §4.1) over a sweep's final state.

A CUDA tensor launches the hand-written kernel; a CPU tensor takes its
plain PyTorch version.  There is no fallback: a kernel that fails to build
or launch raises.
"""

from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import median_cut_scores as median_cut  # noqa: F401
from repro_torch.kernels import median_extremes  # noqa: F401
from repro_torch.kernels import median_extremes_segments  # noqa: F401
from repro_torch.kernels import maxmarg_turn_scan, pegasos_stage  # noqa: F401
from repro_torch.kernels import threshold_ranges, uncertain_mask


def use_kernels_default(device: torch.device) -> bool:
    """The engine's kernel toggles default on for a CUDA device and off on
    the CPU, as the JAX engine's default on for a TPU only."""
    return torch.device(device).type == "cuda"


def ranges(
    V: torch.Tensor,     # (m, d) shared directions
    Wx: torch.Tensor,    # (B, cap, d) transcripts
    Wy: torch.Tensor,    # (B, cap) i32 labels, 0 = empty/padding
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-direction consistent-threshold intervals (lo, hi), each (B, m);
    a missing class yields -inf/+inf."""
    return threshold_ranges(V, Wx.contiguous(), Wy.contiguous())


def uncertain(
    V: torch.Tensor,       # (m, d)
    dir_ok: torch.Tensor,  # (B, m) bool
    lo: torch.Tensor,      # (B, m)
    hi: torch.Tensor,      # (B, m)
    X: torch.Tensor,       # (B, n, d)
    y: torch.Tensor,       # (B, n) i32, 0 = padding
) -> torch.Tensor:
    """Batched SOU membership, bool (B, n); padding rows report False."""
    y = y.contiguous()
    mask = uncertain_mask(V, dir_ok.contiguous(), lo.contiguous(),
                          hi.contiguous(), X.contiguous(), y)
    return mask & (y != 0)
