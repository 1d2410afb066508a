"""The Mamba-1 selective scan: CUDA kernel, wrapper and plain PyTorch
version.

Replaces the TPU kernel ``src/repro/kernels/mamba.py`` (``mamba_scan``,
reached through ``ops.selective_scan``), which the JAX package's model does
not call: its Mamba mixer runs the same recurrence as a ``lax.scan``
(``models/ssm.py`` ``apply_mamba``).  The port's mixer calls
:func:`mamba_scan` instead of a loop, at prefill and (S = 1) at every
decoded token.  The CUDA source is ``csrc/mamba_scan.cu``; its note gives
the bound on an H100 and the design (a thread a channel, 64 registers so
that Jamba's scoring grid runs in one wave, chunks of delta and x
double-buffered with ``cp.async``, the state moved in coalesced 16-byte
pieces).

Unlike the TPU kernel, both versions take an initial state, as the oracle
``ref.mamba_ref(h0=)`` does.  With a zero state they compute the TPU
kernel's function.

Training goes through :func:`mamba_scan_autograd`: the kernel forward, the
plain version's gradient backward in 64-token chunks (:mod:`._grad`).  A
raw :func:`mamba_scan` launch on inputs that require a gradient raises.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build, _ops
from repro_torch.kernels._grad import chunked_vjp, refuse_grad
from repro_torch.kernels.median_cut import _require

STATE_DIMS = (16,)       # the kernel's compiled d_state


def mamba_scan_plain(
    xc: torch.Tensor,                # (B, S, di) conv'd and silu'd inputs
    delta: torch.Tensor,             # (B, S, di) softplus'd step sizes
    A: torch.Tensor,                 # (di, ds), negative
    Bs: torch.Tensor,                # (B, S, ds)
    Cs: torch.Tensor,                # (B, S, ds)
    h0: Optional[torch.Tensor] = None,   # (B, di, ds)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The sequential selective scan, every input converted to f32 first:

      h_t = exp(Δ_t A) h + (Δ_t x_t) B_t;   y_t = h_t C_tᵀ

    Returns y (B, S, di) in xc's dtype and the final state (B, di, ds) in
    f32.  The twin of the JAX package's ``ref.mamba_ref``; the state update
    rounds as the kernel's does."""
    B, S, di = xc.shape
    ds = A.shape[1]
    x, d, Bf, Cf = (a.float() for a in (xc, delta, Bs, Cs))
    A = A.float()
    h = (torch.zeros((B, di, ds), dtype=torch.float32, device=xc.device)
         if h0 is None else h0.float())
    y = torch.empty((B, S, di), dtype=torch.float32, device=xc.device)
    for t in range(S):
        d_t = d[:, t]
        dA = torch.exp(d_t[..., None] * A)                       # (B,di,ds)
        dBx = (d_t * x[:, t])[..., None] * Bf[:, t, None, :]
        h = dA * h + dBx
        y[:, t] = torch.einsum("bds,bs->bd", h, Cf[:, t])
    return y.to(xc.dtype), h


def check_kernel_args(xc, delta, A, Bs, Cs, state=None) -> Tuple[int, ...]:
    """Raise unless the kernel takes these inputs: xc, delta (B, S, di) and
    Bs, Cs (B, S, ds) of one dtype, f32 or bf16; f32 A (di, ds) and an f32
    state (B, di, ds) or None; one device, contiguous and 16-byte aligned,
    ds in :data:`STATE_DIMS`.  Returns (B, S, di, ds)."""
    if xc.dim() != 3 or A.dim() != 2:
        raise ValueError(f"mamba_scan: xc must be (B, S, di) and A (di, ds), "
                         f"got {tuple(xc.shape)} and {tuple(A.shape)}")
    B, S, di = xc.shape
    ds = A.shape[1]
    if ds not in STATE_DIMS:
        raise ValueError(f"mamba_scan: d_state {ds} not in {STATE_DIMS}")
    if not (0 < B <= 65535 and S > 0 and di > 0):
        raise ValueError(f"mamba_scan: unsupported shape {tuple(xc.shape)}")
    if xc.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"mamba_scan: xc has dtype {xc.dtype}, expected "
                        f"float32 or bfloat16")
    dev, f32 = xc.device, torch.float32
    tensors = (xc, delta, A, Bs, Cs) + (() if state is None else (state,))
    # one pass over the common case; _require names what is wrong
    if not (delta.dtype == Bs.dtype == Cs.dtype == xc.dtype
            and A.dtype == f32 and delta.shape == xc.shape
            and A.shape == (di, ds) and Bs.shape == Cs.shape == (B, S, ds)
            and all(t.device == dev and t.is_contiguous() for t in tensors)
            and (state is None or (state.dtype == f32
                                   and state.shape == (B, di, ds)))):
        _require(delta, "delta", xc.dtype, (B, S, di), dev)
        _require(A, "A", f32, (di, ds), dev)
        _require(Bs, "Bs", xc.dtype, (B, S, ds), dev)
        _require(Cs, "Cs", xc.dtype, (B, S, ds), dev)
        if state is not None:
            _require(state, "state", f32, (B, di, ds), dev)
        _require(xc, "xc", xc.dtype, (B, S, di), dev)
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError("mamba_scan: the kernel moves A, the state and its "
                         "staged inputs in 16-byte pieces; they must be "
                         "16-byte aligned")
    return B, S, di, ds


_ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + [ctypes.c_void_p]


def occupancy(dtype: torch.dtype) -> int:
    """Blocks of the kernel for ``dtype`` inputs resident on one SM of the
    current card (the CUDA occupancy calculator)."""
    _, fn = _build.bind("mamba_scan", "mamba_scan_occupancy",
                        [ctypes.c_int, ctypes.c_void_p])
    blocks = ctypes.c_int(0)
    err = fn(int(dtype == torch.bfloat16), ctypes.byref(blocks))
    _build.check(_build.load("mamba_scan"), "mamba_scan", err)
    return blocks.value


def mamba_scan(xc, delta, A, Bs, Cs, state: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The scan of :func:`mamba_scan_plain`.  CUDA tensors launch the kernel
    of ``csrc/mamba_scan.cu`` (and count the launch in
    ``mamba_scan.launches``); CPU tensors take the plain version.
    ``state`` (B, di, ds), f32, is the initial state (zeros when None);
    when given, the final state is written back into it and it is returned
    as the final state.  The kernel takes what :func:`check_kernel_args`
    allows and raises on anything else.  Fake tensors (a traced plan) go
    to the operator ``repro_torch::mamba_scan``, which gives the outputs'
    shapes."""
    if _ops.is_fake(xc) or xc.device.type == "cpu":
        y, final = (_ops.mamba_scan(xc, delta, A, Bs, Cs, state)
                    if _ops.is_fake(xc)
                    else mamba_scan_plain(xc, delta, A, Bs, Cs, h0=state))
        if state is None:
            return y, final
        state.copy_(final)
        return y, state
    if xc.device.type != "cuda":
        raise ValueError(f"mamba_scan runs on cuda or cpu, not {xc.device}")
    refuse_grad("mamba_scan", "kernels.mamba_scan_autograd", xc, delta, A,
                Bs, Cs)
    B, S, di, ds = check_kernel_args(xc, delta, A, Bs, Cs, state)
    final = (torch.empty((B, di, ds), dtype=torch.float32, device=xc.device)
             if state is None else state)
    y = torch.empty_like(xc)
    lib, fn = _build.bind("mamba_scan", "mamba_scan_launch", _ARGTYPES)
    err = _build.launch(
        fn, xc.device, xc.data_ptr(), delta.data_ptr(), A.data_ptr(),
        Bs.data_ptr(), Cs.data_ptr(),
        None if state is None else state.data_ptr(), y.data_ptr(),
        final.data_ptr(), B, S, di, ds, int(xc.dtype == torch.bfloat16))
    _build.check(lib, "mamba_scan", err)
    mamba_scan.launches += 1
    return y, final


mamba_scan.launches = 0


class _SelectiveScan(torch.autograd.Function):
    """The kernel forward; backward the chunked VJP of
    :func:`mamba_scan_plain` (no launch)."""

    @staticmethod
    def forward(ctx, xc, delta, A, Bs, Cs):
        ctx.save_for_backward(xc, delta, A, Bs, Cs)
        return mamba_scan(xc, delta, A, Bs, Cs)

    @staticmethod
    def backward(ctx, dy, dstate):
        if _ops.is_fake(dy):
            return _ops.mamba_scan_vjp(*ctx.saved_tensors, dy, dstate)
        return tuple(chunked_vjp(mamba_scan_plain, ctx.saved_tensors,
                                 (True, True, False, True, True), dy,
                                 dstate))


def mamba_scan_autograd(xc, delta, A, Bs, Cs
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`mamba_scan` from the zero state, differentiable in every
    input: one launch forward on the card (the plain version on the CPU),
    and in backward the plain version's gradient over 64-token chunks, on
    either device.  Returns y and the final state."""
    return _SelectiveScan.apply(xc, delta, A, Bs, Cs)
