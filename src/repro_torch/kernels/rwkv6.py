"""The RWKV-6 (Finch) WKV recurrence: CUDA kernel, wrapper and plain
PyTorch version.

Replaces the TPU kernel ``src/repro/kernels/rwkv6.py`` (``rwkv6_chunked``,
reached through ``ops.rwkv6``), which the JAX package's model does not
call: its time mix runs the same recurrence as a ``lax.scan``
(``models/ssm.py`` ``apply_rwkv_tmix``).  The port's time mix calls
:func:`rwkv6` instead of a loop.  The CUDA source is ``csrc/rwkv6.cu``;
its note gives the bound on an H100 and the design (one step per token,
the state in registers, a value column's rows split over four lanes,
chunks double-buffered with ``cp.async``).  r, k and v may be f32 or
bf16: the time mix passes them in the model's dtype, and both versions
widen them to f32 exactly before any arithmetic, so the two types compute
the same function of the same values.  w (computed in f32 by the model)
and u stay f32.

Unlike the TPU kernel, both versions take an initial state, as the oracle
``ref.rwkv6_ref(S0=)`` does: the serving path carries one.  With a zero
state they compute the TPU kernel's function.

Training goes through :func:`rwkv6_autograd`: the kernel forward, the
plain version's gradient backward in 64-token chunks (:mod:`._grad`).  A
raw :func:`rwkv6` launch on inputs that require a gradient raises.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build, _ops
from repro_torch.kernels._grad import chunked_vjp, refuse_grad
from repro_torch.kernels.median_cut import _require

HEAD_DIMS = (32, 64)     # the kernel's compiled head widths


def rwkv6_plain(
    r: torch.Tensor,                 # (B, S, H, hd)
    k: torch.Tensor,
    v: torch.Tensor,
    w: torch.Tensor,                 # decay in (0, 1)
    u: torch.Tensor,                 # (H, hd) bonus
    S0: Optional[torch.Tensor] = None,   # (B, H, hd, hd)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The sequential WKV recurrence in f32, step by step:

      y_t = r_t · (S + diag(u) k_t v_tᵀ);   S ← diag(w_t) S + k_t v_tᵀ

    r, k, v (and w) may be bf16: they are widened to f32 first.  Returns y
    (B, S, H, hd) and the final state (B, H, hd, hd), both f32.  The twin
    of the JAX package's ``ref.rwkv6_ref``; the state update rounds as the
    kernel's does."""
    B, S, H, hd = r.shape
    r, k, v, w = (a.float() for a in (r, k, v, w))
    u = u.float()[..., None]
    state = (torch.zeros((B, H, hd, hd), dtype=torch.float32,
                         device=r.device)
             if S0 is None else S0.float())
    y = torch.empty((B, S, H, hd), dtype=torch.float32, device=r.device)
    for t in range(S):
        kv = k[:, t, :, :, None] * v[:, t, :, None, :]          # (B,H,hd,hd)
        y[:, t] = torch.einsum("bhk,bhkv->bhv", r[:, t], state + u * kv)
        state = w[:, t, :, :, None] * state + kv
    return y, state


def check_kernel_args(r, k, v, w, u, state=None) -> Tuple[int, ...]:
    """Raise unless the kernel takes these inputs: r, k, v (B, S, H, hd) of
    one dtype, f32 or bf16; f32 w of the same shape and u (H, hd); an f32
    state (B, H, hd, hd) or None; one device, contiguous, r, k, v, w and
    the state 16-byte aligned, hd in :data:`HEAD_DIMS`.  Returns
    (B, S, H, hd)."""
    if r.dim() != 4:
        raise ValueError(f"rwkv6: r must be (B, S, H, hd), got "
                         f"{tuple(r.shape)}")
    B, S, H, hd = r.shape
    if hd not in HEAD_DIMS:
        raise ValueError(f"rwkv6: head width {hd} not in {HEAD_DIMS}")
    if not (0 < B <= 65535 and S > 0 and H > 0):
        raise ValueError(f"rwkv6: unsupported shape {tuple(r.shape)}")
    if r.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"rwkv6: r has dtype {r.dtype}, expected float32 "
                        f"or bfloat16")
    dev, f32 = r.device, torch.float32
    tensors = (r, k, v, w, u) + (() if state is None else (state,))
    # one pass over the common case; _require names what is wrong
    if not (k.dtype == v.dtype == r.dtype and w.dtype == u.dtype == f32
            and k.shape == v.shape == w.shape == r.shape
            and u.shape == (H, hd)
            and all(t.device == dev and t.is_contiguous() for t in tensors)
            and (state is None or (state.dtype == f32
                                   and state.shape == (B, H, hd, hd)))):
        for name, t in (("r", r), ("k", k), ("v", v)):
            _require(t, name, r.dtype, (B, S, H, hd), dev)
        _require(w, "w", f32, (B, S, H, hd), dev)
        _require(u, "u", f32, (H, hd), dev)
        if state is not None:
            _require(state, "state", f32, (B, H, hd, hd), dev)
    if any(t.data_ptr() % 16 for t in (r, k, v, w) + tensors[5:]):
        raise ValueError("rwkv6: the kernel moves r, k, v, w and the state "
                         "in 16-byte pieces; they must be 16-byte aligned")
    return B, S, H, hd


_ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + [ctypes.c_void_p]


def rwkv6(r, k, v, w, u, state: Optional[torch.Tensor] = None
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The recurrence of :func:`rwkv6_plain`.  CUDA tensors launch the
    kernel of ``csrc/rwkv6.cu`` (and count the launch in
    ``rwkv6.launches``); CPU tensors take the plain version.  ``state``
    (B, H, hd, hd), f32, is the initial state (zeros when None); when given,
    the final state is written back into it and it is returned as the
    final state.  The kernel takes what :func:`check_kernel_args` allows
    and raises on anything else.  y and the state are f32 in either input
    type.  Fake tensors (a traced plan) go to the operator
    ``repro_torch::rwkv6``, which gives the outputs' shapes."""
    if _ops.is_fake(r) or r.device.type == "cpu":
        y, final = (_ops.rwkv6(r, k, v, w, u, state) if _ops.is_fake(r)
                    else rwkv6_plain(r, k, v, w, u, S0=state))
        if state is None:
            return y, final
        state.copy_(final)
        return y, state
    if r.device.type != "cuda":
        raise ValueError(f"rwkv6 runs on cuda or cpu, not {r.device}")
    refuse_grad("rwkv6", "kernels.rwkv6_autograd", r, k, v, w, u)
    B, S, H, hd = check_kernel_args(r, k, v, w, u, state)
    dev, f32 = r.device, torch.float32
    final = (torch.empty((B, H, hd, hd), dtype=f32, device=dev)
             if state is None else state)
    y = torch.empty((B, S, H, hd), dtype=f32, device=dev)
    lib, fn = _build.bind("rwkv6", "rwkv6_launch", _ARGTYPES)
    err = _build.launch(
        fn, dev, r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
        u.data_ptr(), None if state is None else state.data_ptr(),
        y.data_ptr(), final.data_ptr(), B, S, H, hd,
        int(r.dtype == torch.bfloat16))
    _build.check(lib, "rwkv6", err)
    rwkv6.launches += 1
    return y, final


rwkv6.launches = 0


class _WKV(torch.autograd.Function):
    """The kernel forward; backward the chunked VJP of :func:`rwkv6_plain`
    (no launch)."""

    @staticmethod
    def forward(ctx, r, k, v, w, u):
        ctx.save_for_backward(r, k, v, w, u)
        return rwkv6(r, k, v, w, u)

    @staticmethod
    def backward(ctx, dy, dstate):
        if _ops.is_fake(dy):
            return _ops.rwkv6_vjp(*ctx.saved_tensors, dy, dstate)
        return tuple(chunked_vjp(rwkv6_plain, ctx.saved_tensors,
                                 (True, True, True, True, False), dy, dstate))


def rwkv6_autograd(r, k, v, w, u) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`rwkv6` from the zero state, differentiable in every input:
    one launch forward on the card (the plain version on the CPU), and in
    backward the plain version's gradient over 64-token chunks, on either
    device.  Returns y and the final state."""
    return _WKV.apply(r, k, v, w, u)
