"""MEDIAN's per-turn weighted-median cut scan: CUDA kernel, wrapper and
plain PyTorch version.

Replaces the TPU kernel ``src/repro/kernels/median_cut.py``
(``median_cut_scores_batched``).  The CUDA source is ``csrc/median_cut.cu``;
its note gives the bound on an H100 and the design.  The wrapper
:func:`median_cut_scores` launches the kernel for CUDA tensors and takes
:func:`median_cut_scores_plain` only for tensors on the CPU.

Scores are integer counts, so the kernel and the plain version agree
exactly; both form every projection as ``(v0*x0) + (v1*x1)`` with one
rounding per operation, as the JAX engine's inline path does.
"""

from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.core.geometry import project
from repro_torch.kernels import _build

# temporaries of the plain version stay near this many elements per chunk
# of instances (the (B, m, n) scan at full size would need tens of GB)
_PLAIN_CHUNK = 1 << 26
_MAX_ANGLES = 9000        # 24 bytes of shared memory a direction: 216 KB


def _cut_chunk(V, dir_ok, lo, hi, X, y) -> torch.Tensor:
    B, m = dir_ok.shape
    proj = project(V, X)                                      # (B, m, n)
    nonempty = (lo < hi) & dir_ok
    lo_r = lo.masked_fill(~nonempty, math.inf)
    hi_r = hi.masked_fill(~nonempty, -math.inf)
    risk = torch.where((y == 1)[:, None, :], proj > lo_r[:, :, None],
                       proj < hi_r[:, :, None])
    # a point's arc lies wholly <= cut i iff its last risk row is <= i, and
    # wholly > i iff its first risk row is > i: histograms of first/last
    # rows give every cut's counts
    idx = torch.arange(m, dtype=torch.int32, device=X.device)[None, :, None]
    last = torch.where(risk, idx, -1).amax(dim=1)             # (B, n)
    first = torch.where(risk, idx, m).amin(dim=1)
    livei = ((last >= 0) & (y != 0)).to(torch.int32)
    zeros = torch.zeros((B, m), dtype=torch.int32, device=X.device)
    hist_last = zeros.scatter_add(1, last.clamp(0, m - 1).long(), livei)
    hist_first = zeros.scatter_add(1, first.clamp(0, m - 1).long(), livei)
    below = torch.cumsum(hist_last, dim=1, dtype=torch.int32)
    above = (livei.sum(dim=1, dtype=torch.int32)[:, None]
             - torch.cumsum(hist_first, dim=1, dtype=torch.int32))
    return torch.where(dir_ok, torch.minimum(below, above),
                       -1).to(torch.int32)


def median_cut_scores_plain(
    V: torch.Tensor,        # (m, d) f32 shared directions
    dir_ok: torch.Tensor,   # (B, m) bool
    lo: torch.Tensor,       # (B, m) f32
    hi: torch.Tensor,       # (B, m) f32
    X: torch.Tensor,        # (B, n, d) f32
    y: torch.Tensor,        # (B, n) i32 ±1, 0 = padding
) -> torch.Tensor:
    """(B, m) int32 median-cut scores, -1 at disallowed cuts: for every
    allowed direction, the smaller of the counts of live points whose whole
    at-risk arc lies on each side of it.  The histogram formulation of the
    JAX engine's inline path (``repro.engine.median.step``, stage 2), taken
    in chunks of instances so the (B, m, n) temporaries stay bounded."""
    per_instance = dir_ok.shape[1] * X.shape[1]
    return torch.cat([_cut_chunk(V, *a) for a in plain_chunks(
        per_instance, dir_ok, lo, hi, X, y)])


def plain_chunks(per_instance: int, *arrays):
    """Slice batch-leading ``arrays`` into chunks of instances whose
    (instance, direction, point) temporaries stay near ``_PLAIN_CHUNK``
    elements; ``per_instance`` is one instance's count.  Yields tuples."""
    B = arrays[0].shape[0]
    per = max(1, _PLAIN_CHUNK // max(1, per_instance))
    for s in range(0, max(B, 1), per):      # one (empty) chunk at B=0
        yield tuple(a[s:s + per] for a in arrays)


def _require(t: torch.Tensor, name: str, dtype, shape, device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def check_kernel_args(V, dir_ok, lo, hi, X, y):
    """Raise unless the kernel takes these inputs: f32 V (m, 2), bool dir_ok
    (B, m), f32 lo and hi (B, m), f32 X (B, n, 2) and int32 y (B, n), on one
    device and contiguous (V and X 8-byte aligned: the kernel reads points
    and directions as pairs), with 0 < m <= ``_MAX_ANGLES``.  Returns
    (B, m, n)."""
    B, m = dir_ok.shape
    n = X.shape[1]
    if not (0 < m <= _MAX_ANGLES and 0 < B <= 65535 and n > 0):
        raise ValueError(f"median_cut_scores: unsupported shape B={B}, "
                         f"m={m}, n={n}")
    dev = X.device
    _require(V, "V", torch.float32, (m, 2), dev)
    _require(dir_ok, "dir_ok", torch.bool, (B, m), dev)
    _require(lo, "lo", torch.float32, (B, m), dev)
    _require(hi, "hi", torch.float32, (B, m), dev)
    _require(X, "X", torch.float32, (B, n, 2), dev)
    _require(y, "y", torch.int32, (B, n), dev)
    if V.data_ptr() % 8 or X.data_ptr() % 8:
        raise ValueError("median_cut_scores: V and X must be 8-byte aligned")
    return B, m, n


_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 3 + [ctypes.c_void_p]


def median_cut_scores(V, dir_ok, lo, hi, X, y) -> torch.Tensor:
    """The cut scan of :func:`median_cut_scores_plain`.  CUDA tensors launch
    the kernel of ``csrc/median_cut.cu``, one launch a call (counted in
    ``median_cut_scores.launches``); CPU tensors take the plain version."""
    if X.device.type == "cpu":
        return median_cut_scores_plain(V, dir_ok, lo, hi, X, y)
    if X.device.type != "cuda":
        raise ValueError(f"median_cut_scores runs on cuda or cpu, "
                         f"not {X.device}")
    B, m, n = check_kernel_args(V, dir_ok, lo, hi, X, y)
    dev = X.device
    score = torch.empty((B, m), dtype=torch.int32, device=dev)
    lib, fn = _build.bind("median_cut", "median_cut_launch", _ARGTYPES)
    err = _build.launch(fn, dev, V.data_ptr(), dir_ok.data_ptr(),
                        lo.data_ptr(), hi.data_ptr(), X.data_ptr(),
                        y.data_ptr(), score.data_ptr(), B, m, n)
    _build.check(lib, "median_cut", err)
    median_cut_scores.launches += 1
    return score


median_cut_scores.launches = 0
