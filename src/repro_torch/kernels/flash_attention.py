"""Online-softmax GQA attention: CUDA kernels, wrapper and plain PyTorch
version.

Replaces the TPU kernel ``src/repro/kernels/flash_attention.py``
(``flash_attention``, reached through ``ops.attention``).  The wrapper
:func:`attention` launches one of three CUDA routes for CUDA tensors, the
one :func:`attention_route` names for the call's dtype and shape, and takes
:func:`attention_plain` only for tensors on the CPU:

* ``"tc"`` (``csrc/flash_attention_tc.cu``): bf16 at head width 64 or
  128 with more than :data:`SPLITKV_MAX_SQ` query rows, on the tensor
  cores (``wgmma``, TMA);
* ``"splitkv"`` (``csrc/flash_attention_splitkv.cu``): at most
  :data:`SPLITKV_MAX_SQ` query rows, any supported dtype and head width:
  the keys split across blocks, partial softmax statistics merged by a
  second kernel (decode-time cross-attention);
* ``"simt"`` (``csrc/flash_attention.cu``): every other supported call (f32,
  bf16 at head width 32 or 256), f32 on the CUDA cores.

Each source's note gives its bound on an H100 and its design.  The routes
compute the same function and are declared, not tried: a call that no
route takes raises.

All keep the JAX function's layout, q (B, Sq, H, hd) and k, v (B, Skv, KV,
hd), with queries at positions 0..Sq-1.  The kernels follow the TPU
kernel's online softmax (f32 scores and statistics, a row with nothing to
attend to gives 0); the plain version is the dense softmax of the JAX
package's oracle ``ref.attention_ref``.  They agree to float rounding, not
bit for bit.  No padding: the TPU wrapper's padding of Sq and Skv to tile
multiples is a tiling artifact, and the kernels bound their tiles instead.

The kernels have no backward, as the TPU kernel has no VJP: a launch on
inputs that require a gradient raises, and training takes the plain
attention pass of ``models.layers``.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from repro_torch.kernels import _build, _ops
from repro_torch.kernels._grad import refuse_grad
from repro_torch.kernels.median_cut import _require

HEAD_DIMS = (32, 64, 128, 256)     # the kernels' compiled head widths
TC_HEAD_DIMS = (64, 128)           # the tensor-core route's (bf16)
SPLITKV_MAX_SQ = 16                # query rows up to which keys are split
ROUTES = ("tc", "splitkv", "simt")


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


def attention_route(dtype: torch.dtype, hd: int, Sq: int, Skv: int) -> str:
    """The route :func:`attention` launches for a call on the card: a pure
    function of the call's dtype, head width and lengths.  Up to
    :data:`SPLITKV_MAX_SQ` query rows split the keys (any length: ``Skv``
    does not move the choice today); bf16 at a head width in
    :data:`TC_HEAD_DIMS` takes the tensor cores; the rest, f32 among them,
    the CUDA cores (the f32 tiers leave no room for TF32)."""
    del Skv
    if Sq <= SPLITKV_MAX_SQ:
        return "splitkv"
    if dtype == torch.bfloat16 and hd in TC_HEAD_DIMS:
        return "tc"
    return "simt"


def split_keys(hd: int) -> int:
    """Keys one split-KV block stages: ``split_keys`` in
    ``csrc/flash_attention_splitkv.cu``."""
    return 8192 // hd


_ARGS = {
    "simt": ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 10
             + [ctypes.c_float, ctypes.c_void_p]),
    "tc": ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 9
           + [ctypes.c_float, ctypes.c_void_p]),
    "splitkv": ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 11
                + [ctypes.c_float, ctypes.c_void_p]),
}
_STEM = {"simt": "flash_attention", "tc": "flash_attention_tc",
         "splitkv": "flash_attention_splitkv"}


_BOUND: dict = {}


def _bound(route: str):
    """(library, stem, C entry point) of a route, bound once."""
    got = _BOUND.get(route)
    if got is None:
        stem = _STEM[route]
        lib = _build.load(stem)
        fn = getattr(lib, f"{stem}_launch")
        fn.restype = ctypes.c_int
        fn.argtypes = _ARGS[route]
        got = _BOUND[route] = (lib, stem, fn)
    return got


def attention(q, k, v, *, causal: bool, window: Optional[int] = None,
              kv_valid: Optional[int] = None) -> torch.Tensor:
    """The attention of :func:`attention_plain`.  CUDA tensors launch the
    route that :func:`attention_route` names (counted in
    ``attention.launches`` and, per route, ``attention.routes``); CPU
    tensors take the plain version.  The kernels take f32 or bf16 q, k, v
    of one dtype, contiguous, with one head width in :data:`HEAD_DIMS` for
    q, k and v (16-byte aligned for the tc and splitkv routes); anything
    else raises.  Fake tensors (a traced plan) go to the operator
    ``repro_torch::attention``, which gives the output's shape."""
    if _ops.is_fake(q) and kv_valid is None:
        return _ops.attention(q, k, v, causal, window)
    if q.device.type == "cpu":
        return attention_plain(q, k, v, causal=causal, window=window,
                               kv_valid=kv_valid)
    if q.device.type != "cuda":
        raise ValueError(f"attention runs on cuda or cpu, not {q.device}")
    refuse_grad("attention", "the plain attention pass "
                "(models.layers.set_attention_impl('plain'))", q, k, v)
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
    # one pass over the common case; _require names what is wrong
    if not (k.dtype == q.dtype == v.dtype and k.device == dev == v.device
            and k.shape == v.shape == (B, Skv, KV, hd) and q.is_contiguous()
            and k.is_contiguous() and v.is_contiguous()):
        _require(q, "q", q.dtype, (B, Sq, H, hd), dev)
        _require(k, "k", q.dtype, (B, Skv, KV, hd), dev)
        _require(v, "v", q.dtype, (B, Skv, KV, hd), dev)
    route = attention_route(q.dtype, hd, Sq, Skv)
    if route != "simt" and any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError(f"attention: the {route} route reads q, k and v in "
                         f"16-byte pieces; they must be 16-byte aligned")
    out = torch.empty_like(q)
    kv_end = Skv if kv_valid is None else min(kv_valid, Skv)
    win = 0 if window is None else window
    scale = 1.0 / math.sqrt(hd)
    lib, stem, fn = _bound(route)

    def launch() -> int:
        # the raw handle: a decode step makes dozens of these calls, and
        # torch.cuda.current_stream() builds a Stream object each time
        stream = torch._C._cuda_getCurrentRawStream(dev.index)
        ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr())
        if route == "tc":
            return fn(*ptrs, B, Sq, Skv, H, KV, hd, int(causal), win, kv_end,
                      scale, stream)
        if route == "splitkv":
            # scratch: each split's acc (nsplit, B, KV, R, hd), then its
            # (m, l) (nsplit, B, KV, R, 2), f32
            nsplit = max(1, -(-kv_end // split_keys(hd)))
            rows = nsplit * B * KV * (H // KV) * Sq
            scratch = torch.empty(rows * (hd + 2), dtype=torch.float32,
                                  device=dev)
            acc = scratch.data_ptr()
            return fn(*ptrs, acc, acc + 4 * rows * hd, B, Sq, Skv, H, KV, hd,
                      int(q.dtype == torch.bfloat16), int(causal), win,
                      kv_end, nsplit, scale, stream)
        return fn(*ptrs, B, Sq, Skv, H, KV, hd,
                  int(q.dtype == torch.bfloat16), int(causal), win, kv_end,
                  scale, stream)

    # entering torch.cuda.device costs more than these kernels' launch:
    # only when q is not on the current device
    if dev.index == torch.cuda.current_device():
        err = launch()
    else:
        with torch.cuda.device(dev):
            err = launch()
    _build.check(lib, stem, err)
    attention.launches += 1
    attention.routes[route] += 1
    return out


attention.launches = 0
attention.routes = dict.fromkeys(ROUTES, 0)
