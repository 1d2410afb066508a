"""The model's three kernels (attention, WKV, selective scan) as PyTorch
operators, for tracing.

A wrapper handed fake tensors (``FakeTensorMode``: the dry-run planner,
``repro_torch.launch.dryrun``) cannot launch anything: it calls the
operator here instead, whose fake implementation gives the outputs' shapes
and dtypes and whose FLOP formula (``torch.utils.flop_counter``) counts the
kernel's operations, as ``chip_smoke.py``'s bounds count them:

* ``repro_torch::attention``: 4·hd per kept (query, key) pair;
* ``repro_torch::rwkv6``: 5 per (step, i, j) and 5 per (step, j) of a
  head's hd × hd state;
* ``repro_torch::mamba_scan``: 6 per (step, channel, state).

The ``*_vjp`` operators stand for the scans' chunked backward
(:func:`repro_torch.kernels._grad.chunked_vjp`, which the autograd
Functions run on real tensors) in a traced plan: shapes only, counted as
four forward passes (the boundary pass, the recomputed chunk and its
gradient, twice the forward).  Every operator here has a fake
implementation alone: real tensors go to the wrappers, which launch the
kernel on the card and run the plain version on the CPU.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch.utils.flop_counter import register_flop_formula


def is_fake(t) -> bool:
    """Whether ``t`` is a fake tensor (shapes only, no storage to launch
    on)."""
    from torch._subclasses.fake_tensor import is_fake as _is_fake
    return type(t) is not torch.Tensor and _is_fake(t)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

torch.library.define(
    "repro_torch::attention",
    "(Tensor q, Tensor k, Tensor v, bool causal, int? window) -> Tensor")
attention = torch.ops.repro_torch.attention


@torch.library.register_fake("repro_torch::attention")
def _(q, k, v, causal, window):
    return q.new_empty(q.shape[:-1] + v.shape[-1:])


def kept_pairs(Sq: int, Skv: int, causal: bool,
               window: Optional[int]) -> int:
    """(query, key) pairs the mask keeps, queries at 0..Sq-1."""
    i = np.arange(Sq, dtype=np.int64)
    hi = np.minimum(i + 1, Skv) if causal else np.full(Sq, Skv)
    lo = np.maximum(0, i - window + 1) if window is not None else 0
    return int(np.maximum(0, hi - lo).sum())


@register_flop_formula(torch.ops.repro_torch.attention)
def _(q_shape, k_shape, v_shape, causal, window, *args, **kwargs) -> int:
    B, Sq, H, hd = q_shape
    return 4 * hd * B * H * kept_pairs(Sq, k_shape[1], causal, window)


# ---------------------------------------------------------------------------
# WKV
# ---------------------------------------------------------------------------

torch.library.define(
    "repro_torch::rwkv6",
    "(Tensor r, Tensor k, Tensor v, Tensor w, Tensor u, Tensor? state) "
    "-> (Tensor, Tensor)")
rwkv6 = torch.ops.repro_torch.rwkv6


@torch.library.register_fake("repro_torch::rwkv6")
def _(r, k, v, w, u, state):
    B, S, H, hd = r.shape
    f32 = torch.float32
    return (r.new_empty((B, S, H, hd), dtype=f32),
            r.new_empty((B, H, hd, hd), dtype=f32))


def _wkv_flops(r_shape) -> int:
    B, S, H, hd = r_shape
    return 5 * B * S * H * hd * (hd + 1)


@register_flop_formula(torch.ops.repro_torch.rwkv6)
def _(r_shape, *args, **kwargs) -> int:
    return _wkv_flops(r_shape)


torch.library.define(
    "repro_torch::rwkv6_vjp",
    "(Tensor r, Tensor k, Tensor v, Tensor w, Tensor u, Tensor dy, "
    "Tensor? dstate) -> (Tensor, Tensor, Tensor, Tensor, Tensor)")
rwkv6_vjp = torch.ops.repro_torch.rwkv6_vjp


@torch.library.register_fake("repro_torch::rwkv6_vjp")
def _(r, k, v, w, u, dy, dstate):
    return tuple(torch.empty_like(a) for a in (r, k, v, w, u))


@register_flop_formula(torch.ops.repro_torch.rwkv6_vjp)
def _(r_shape, *args, **kwargs) -> int:
    return 4 * _wkv_flops(r_shape)


# ---------------------------------------------------------------------------
# selective scan
# ---------------------------------------------------------------------------

torch.library.define(
    "repro_torch::mamba_scan",
    "(Tensor xc, Tensor delta, Tensor A, Tensor Bs, Tensor Cs, Tensor? "
    "state) -> (Tensor, Tensor)")
mamba_scan = torch.ops.repro_torch.mamba_scan


@torch.library.register_fake("repro_torch::mamba_scan")
def _(xc, delta, A, Bs, Cs, state):
    B, S, di = xc.shape
    return (torch.empty_like(xc),
            xc.new_empty((B, di, A.shape[1]), dtype=torch.float32))


def _scan_flops(xc_shape, A_shape) -> int:
    B, S, di = xc_shape
    return 6 * B * S * di * A_shape[1]


@register_flop_formula(torch.ops.repro_torch.mamba_scan)
def _(xc_shape, delta_shape, A_shape, *args, **kwargs) -> int:
    return _scan_flops(xc_shape, A_shape)


torch.library.define(
    "repro_torch::mamba_scan_vjp",
    "(Tensor xc, Tensor delta, Tensor A, Tensor Bs, Tensor Cs, Tensor dy, "
    "Tensor? dstate) -> (Tensor, Tensor, Tensor, Tensor, Tensor)")
mamba_scan_vjp = torch.ops.repro_torch.mamba_scan_vjp


@torch.library.register_fake("repro_torch::mamba_scan_vjp")
def _(xc, delta, A, Bs, Cs, dy, dstate):
    return tuple(torch.empty_like(a) for a in (xc, delta, A, Bs, Cs))


@register_flop_formula(torch.ops.repro_torch.mamba_scan_vjp)
def _(xc_shape, delta_shape, A_shape, *args, **kwargs) -> int:
    return 4 * _scan_flops(xc_shape, A_shape)
