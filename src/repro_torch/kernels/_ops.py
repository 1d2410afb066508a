"""The model's three kernels (attention, WKV, selective scan) as PyTorch
operators, for tracing.

A wrapper handed fake tensors (``FakeTensorMode``: the dry-run planner,
``repro_torch.launch.dryrun``) cannot launch anything: it calls the
operator here instead, whose fake implementation gives the outputs' shapes
and dtypes and whose FLOP formula (``torch.utils.flop_counter``) counts the
kernel's operations through :mod:`repro_torch.analysis.bounds`, the
functions every kernel bound is made of:

* ``repro_torch::attention``: 4·hd per kept (query, key) pair
  (:func:`~repro_torch.analysis.bounds.attention_ops`);
* ``repro_torch::rwkv6``: 5 per (step, i, j) and 5 per (step, j) of a
  head's hd × hd state (:func:`~repro_torch.analysis.bounds.wkv_ops`);
* ``repro_torch::mamba_scan``: 6 per (step, channel, state)
  (:func:`~repro_torch.analysis.bounds.scan_ops`; its exponentials are
  not FLOPs here).

The ``*_vjp`` operators stand for the scans' chunked backward
(:func:`repro_torch.kernels._grad.chunked_vjp`, which the autograd
Functions run on real tensors) in a traced plan: shapes only, counted as
four forward passes (the boundary pass, the recomputed chunk and its
gradient, twice the forward).  Every operator here has a fake
implementation alone: real tensors go to the wrappers, which launch the
kernel on the card and run the plain version on the CPU.
"""

from __future__ import annotations

import torch
from torch.utils.flop_counter import register_flop_formula

from repro_torch.analysis.bounds import attention_ops, scan_ops, wkv_ops


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


@register_flop_formula(torch.ops.repro_torch.attention)
def _(q_shape, k_shape, v_shape, causal, window, *args, **kwargs) -> int:
    return attention_ops(q_shape, k_shape[1], causal, window)


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


@register_flop_formula(torch.ops.repro_torch.rwkv6)
def _(r_shape, *args, **kwargs) -> int:
    return wkv_ops(*r_shape)


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
    return 4 * wkv_ops(*r_shape)


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
    return scan_ops(*xc_shape, A_shape[1]).ops


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
