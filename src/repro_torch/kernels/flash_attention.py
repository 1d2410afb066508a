"""Online-softmax GQA attention: CUDA kernel, wrapper and plain PyTorch
version.

Replaces the TPU kernel ``src/repro/kernels/flash_attention.py``
(``flash_attention``, reached through ``ops.attention``).  The CUDA source
is ``csrc/flash_attention.cu``; its note gives the bound on an H100 and the
design.  The wrapper :func:`attention` launches the kernel for CUDA tensors
and takes :func:`attention_plain` only for tensors on the CPU.

Both keep the JAX function's layout, q (B, Sq, H, hd) and k, v (B, Skv,
KV, hd), with queries at positions 0..Sq-1.  The kernel follows the TPU
kernel's online softmax tile by tile (f32 scores and statistics, masked
scores -1e30, a row with nothing to attend to gives 0); the plain version
is the dense softmax of the JAX package's oracle ``ref.attention_ref``.
They agree to float rounding, not bit for bit.  No padding: the TPU
wrapper's padding of Sq and Skv to tile multiples is a tiling artifact, and
the kernel bounds its tiles instead.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.median_cut import _require

HEAD_DIMS = (32, 64, 128, 256)     # the kernel's compiled head widths


def _mask(Sq: int, Skv: int, causal: bool, window: Optional[int],
          kv_valid: Optional[int], device) -> torch.Tensor:
    rows = torch.arange(Sq, device=device)[:, None]
    cols = torch.arange(Skv, device=device)[None, :]
    mask = torch.ones((Sq, Skv), dtype=torch.bool, device=device)
    if causal:
        mask &= cols <= rows
    if window is not None:
        mask &= cols > rows - window
    if kv_valid is not None:
        mask &= cols < kv_valid
    return mask


def attention_plain(
    q: torch.Tensor,                # (B, Sq, H, hd)
    k: torch.Tensor,                # (B, Skv, KV, hd)
    v: torch.Tensor,                # (B, Skv, KV, hdv)
    *,
    causal: bool,
    window: Optional[int] = None,
    kv_valid: Optional[int] = None,
) -> torch.Tensor:
    """Dense softmax attention with GQA broadcast, (B, Sq, H, hdv) in q's
    dtype: f32 scores divided by sqrt(hd), masked to -inf, softmax, rows
    with nothing to attend to set to 0.  The twin of the JAX package's
    ``ref.attention_ref`` (at ``q_offset=0``)."""
    B, Sq, H, hd = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    G = H // KV
    k = k.repeat_interleave(G, dim=2)
    v = v.repeat_interleave(G, dim=2)
    s = torch.einsum("bqhd,bshd->bhqs", q.float(), k.float()) / math.sqrt(hd)
    mask = _mask(Sq, Skv, causal, window, kv_valid, q.device)
    s = s.masked_fill(~mask, -math.inf)
    p = torch.softmax(s, dim=-1)
    p = torch.where(torch.isnan(p), 0.0, p)
    return torch.einsum("bhqs,bshd->bqhd", p, v.float()).to(q.dtype)


def _bound() -> ctypes.CDLL:
    lib = _build.load("flash_attention")
    fn = lib.flash_attention_launch
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 10
                   + [ctypes.c_float, ctypes.c_void_p])
    return lib


def attention(q, k, v, *, causal: bool, window: Optional[int] = None,
              kv_valid: Optional[int] = None) -> torch.Tensor:
    """The attention of :func:`attention_plain`.  CUDA tensors launch the
    kernel of ``csrc/flash_attention.cu`` (and count the launch in
    ``attention.launches``); CPU tensors take the plain version.  The kernel
    takes f32 or bf16 q, k, v of one dtype, contiguous, with one head width
    in :data:`HEAD_DIMS` for q, k and v; anything else raises."""
    if q.device.type == "cpu":
        return attention_plain(q, k, v, causal=causal, window=window,
                               kv_valid=kv_valid)
    if q.device.type != "cuda":
        raise ValueError(f"attention runs on cuda or cpu, not {q.device}")
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError(f"attention: q and k must be (B, S, heads, hd), got "
                         f"{tuple(q.shape)} and {tuple(k.shape)}")
    B, Sq, H, hd = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    if v.shape[-1] != hd:
        raise ValueError(f"attention: the kernel needs hdv == hd, got "
                         f"hd={hd}, hdv={v.shape[-1]}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"attention: head width {hd} not in {HEAD_DIMS}")
    if not (0 < B <= 65535 and 0 < H <= 65535 and Sq > 0 and Skv > 0
            and 0 < KV <= H and H % KV == 0):
        raise ValueError(f"attention: unsupported shape q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}")
    if window is not None and window < 1:
        raise ValueError(f"attention: window must be >= 1, got {window}")
    if kv_valid is not None and kv_valid < 0:
        raise ValueError(f"attention: kv_valid must be >= 0, got {kv_valid}")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"attention: q has dtype {q.dtype}, expected float32 "
                        f"or bfloat16")
    dev = q.device
    _require(q, "q", q.dtype, (B, Sq, H, hd), dev)
    _require(k, "k", q.dtype, (B, Skv, KV, hd), dev)
    _require(v, "v", q.dtype, (B, Skv, KV, hd), dev)
    out = torch.empty_like(q)
    kv_end = Skv if kv_valid is None else min(kv_valid, Skv)
    lib = _bound()
    with torch.cuda.device(dev):
        err = lib.flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            B, Sq, Skv, H, KV, hd, int(q.dtype == torch.bfloat16),
            int(causal), 0 if window is None else window, kv_end,
            1.0 / math.sqrt(hd), torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, "flash_attention", err)
    attention.launches += 1
    return out


attention.launches = 0
