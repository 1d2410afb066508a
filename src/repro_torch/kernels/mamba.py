"""The Mamba-1 selective scan: CUDA kernel, wrapper and plain PyTorch
version.

Replaces the TPU kernel ``src/repro/kernels/mamba.py`` (``mamba_scan``,
reached through ``ops.selective_scan``), which the JAX package's model does
not call: its Mamba mixer runs the same recurrence as a ``lax.scan``
(``models/ssm.py`` ``apply_mamba``).  The port's mixer calls
:func:`mamba_scan` instead of a loop, at prefill and (S = 1) at every
decoded token.  The CUDA source is ``csrc/mamba_scan.cu``; its note gives
the bound on an H100 and the design.

Unlike the TPU kernel, both versions take an initial state, as the oracle
``ref.mamba_ref(h0=)`` does.  With a zero state they compute the TPU
kernel's function.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build
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


def _bound() -> ctypes.CDLL:
    lib = _build.load("mamba_scan")
    fn = lib.mamba_scan_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + \
        [ctypes.c_void_p]
    return lib


def mamba_scan(xc, delta, A, Bs, Cs, state: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The scan of :func:`mamba_scan_plain`.  CUDA tensors launch the kernel
    of ``csrc/mamba_scan.cu`` (and count the launch in
    ``mamba_scan.launches``); CPU tensors take the plain version.
    ``state`` (B, di, ds), f32, is the initial state (zeros when None);
    when given, the final state is written back into it and it is returned
    as the final state.  The kernel takes xc, delta (B, S, di) and Bs, Cs
    (B, S, ds) all f32 or all bf16, A (di, ds) f32, contiguous, with ds in
    :data:`STATE_DIMS`; anything else raises."""
    if xc.device.type == "cpu":
        y, final = mamba_scan_plain(xc, delta, A, Bs, Cs, h0=state)
        if state is None:
            return y, final
        state.copy_(final)
        return y, state
    if xc.device.type != "cuda":
        raise ValueError(f"mamba_scan runs on cuda or cpu, not {xc.device}")
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
    _require(xc, "xc", xc.dtype, (B, S, di), dev)
    _require(delta, "delta", xc.dtype, (B, S, di), dev)
    _require(A, "A", f32, (di, ds), dev)
    _require(Bs, "Bs", xc.dtype, (B, S, ds), dev)
    _require(Cs, "Cs", xc.dtype, (B, S, ds), dev)
    if state is None:
        final = torch.empty((B, di, ds), dtype=f32, device=dev)
    else:
        _require(state, "state", f32, (B, di, ds), dev)
        final = state
    y = torch.empty_like(xc)
    lib = _bound()
    with torch.cuda.device(dev):
        err = lib.mamba_scan_launch(
            xc.data_ptr(), delta.data_ptr(), A.data_ptr(), Bs.data_ptr(),
            Cs.data_ptr(), None if state is None else state.data_ptr(),
            y.data_ptr(), final.data_ptr(), B, S, di, ds,
            int(xc.dtype == torch.bfloat16),
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, "mamba_scan", err)
    mamba_scan.launches += 1
    return y, final


mamba_scan.launches = 0
