"""MEDIAN's stage-5 per-node extremes scan: CUDA kernel, wrapper and plain
PyTorch version.

Replaces the TPU kernel ``src/repro/kernels/support_margin.py``
(``median_extremes_batched``).  The CUDA source is
``csrc/median_extremes.cu``; its note gives the bound on an H100 and the
design.  The wrapper :func:`median_extremes` launches the kernel for CUDA
tensors and takes :func:`median_extremes_plain` only for tensors on the
CPU.  Row choices are integers, so the two agree exactly; both form the
projection as ``(x0*v0) + (x1*v1)`` with one rounding per operation.
"""

from __future__ import annotations

import ctypes
import math
from typing import Tuple

import torch

from repro_torch.core.geometry import project_each
from repro_torch.kernels import _build
from repro_torch.kernels.median_cut import _require


def median_extremes_plain(
    v: torch.Tensor,    # (B, d) f32 per-instance proposed directions
    XW: torch.Tensor,   # (B, k, nW, d) f32 own ∪ fill-capped transcripts
    yW: torch.Tensor,   # (B, k, nW) i32 ±1, 0 = padding
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per node, the first-index argmax of the projection on v over +1 rows
    (``i_p``) and the first-index argmin over -1 rows (``i_q``), each (B, k)
    int32; index 0 where the class is absent."""
    pj = project_each(XW, v)
    i_p = pj.masked_fill(yW != 1, -math.inf).argmax(dim=2)
    i_q = pj.masked_fill(yW != -1, math.inf).argmin(dim=2)
    return i_p.to(torch.int32), i_q.to(torch.int32)


def _bound() -> ctypes.CDLL:
    lib = _build.load("median_extremes")
    fn = lib.median_extremes_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + \
        [ctypes.c_void_p]
    return lib


def median_extremes(v, XW, yW) -> Tuple[torch.Tensor, torch.Tensor]:
    """The extremes scan of :func:`median_extremes_plain`.  CUDA tensors
    launch the kernel of ``csrc/median_extremes.cu`` (and count the launch
    in ``median_extremes.launches``); CPU tensors take the plain version."""
    if XW.device.type == "cpu":
        return median_extremes_plain(v, XW, yW)
    if XW.device.type != "cuda":
        raise ValueError(f"median_extremes runs on cuda or cpu, "
                         f"not {XW.device}")
    B, k, nW = yW.shape
    if B * k == 0 or nW == 0:
        raise ValueError(f"median_extremes: empty shape {(B, k, nW)}")
    dev = XW.device
    _require(v, "v", torch.float32, (B, 2), dev)
    _require(XW, "XW", torch.float32, (B, k, nW, 2), dev)
    _require(yW, "yW", torch.int32, (B, k, nW), dev)
    i_p = torch.empty((B, k), dtype=torch.int32, device=dev)
    i_q = torch.empty((B, k), dtype=torch.int32, device=dev)
    lib = _bound()
    with torch.cuda.device(dev):
        err = lib.median_extremes_launch(
            v.data_ptr(), XW.data_ptr(), yW.data_ptr(), i_p.data_ptr(),
            i_q.data_ptr(), B, k, nW,
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, "median_extremes", err)
    median_extremes.launches += 1
    return i_p, i_q


median_extremes.launches = 0
