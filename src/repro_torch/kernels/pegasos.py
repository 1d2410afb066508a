"""One λ stage of the batched Pegasos solver (the MAXMARG refit): CUDA
kernel, wrapper and plain PyTorch version.

Replaces the TPU kernel ``src/repro/kernels/pegasos.py``
(``pegasos_stage_batched``).  The CUDA source is ``csrc/pegasos_stage.cu``;
its note gives the bound on an H100 and the design.  The wrapper
:func:`pegasos_stage` launches the kernel for CUDA tensors and takes
:func:`pegasos_stage_plain` only for tensors on the CPU.

Both form every margin as ``((x0*w0) + (x1*w1) + ...) + b`` left to right
over d, one rounding per operation, apply the same update with correctly
rounded square roots (:func:`sqrt_rn`), and sum the hinge gradient over the
N rows in the same order: the plain version spells out the reduction of
the kernel's warp (:func:`block_sum`).  So the two agree bit for bit, on
the card and on the CPU, and with the JAX package's twin (an einsum) to a
tolerance.
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from repro_torch.analysis import autotune, bounds
from repro_torch.core.geometry import decide
from repro_torch.kernels import _build
from repro_torch.kernels.median_cut import _require

BIG = 1e30          # min margin of an instance without valid rows
_MAX_D = 4096       # above d=16 w and its gradient sit in shared memory
THREADS = 32        # lanes per instance: kThreads in csrc/pegasos_stage.cu
SMALL_D = 16        # kSmallD: up to here w and its gradient sit in registers
WARPS = (1, 2, 4, 8)    # instances a block the kernel takes (kMaxWarps 8)


def sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded f32 square root, on any device, as the
    kernel's ``__fsqrt_rn``.  torch's CPU ``sqrt`` goes through MKL's VML
    (high-accuracy mode, not correctly rounded: some f32 inputs come out
    1 ulp off), so its result is corrected: the rounded root lies between
    the midpoints to its neighbours, which have at most 25 significant
    bits, so their squares are exact in float64."""
    s = torch.sqrt(x)
    up = torch.nextafter(s, torch.full_like(s, math.inf))
    dn = torch.nextafter(s, torch.zeros_like(s))
    xd, sd = x.double(), s.double()
    m_hi = (sd + up.double()) * 0.5
    m_lo = (sd + dn.double()) * 0.5
    return torch.where(xd > m_hi * m_hi, up,
                       torch.where(xd < m_lo * m_lo, dn, s))


def block_sum(c: torch.Tensor) -> torch.Tensor:
    """(B, N, d) -> (B, d): the sum over the N rows in the kernel's order.
    Lane t of the instance's warp adds rows t, t+THREADS, ... one at a time
    onto 0; then the lanes fold at offsets 16, 8, 4, 2, 1, lane t adding
    lane t + offset (the kernel's xor fold gives every lane this value)."""
    B, N, d = c.shape
    R = -(-N // THREADS)
    c = torch.nn.functional.pad(c, (0, 0, 0, R * THREADS - N))
    c = c.reshape(B, R, THREADS, d)
    lanes = torch.zeros((B, THREADS, d), dtype=c.dtype, device=c.device)
    for r in range(R):
        lanes = lanes + c[:, r]
    off = THREADS // 2
    while off:
        lanes = lanes[:, :off] + lanes[:, off:2 * off]
        off //= 2
    return lanes[:, 0]


def pegasos_stage_plain(
    X: torch.Tensor,       # (B, N, d) f32; label-0 rows are padding
    y: torch.Tensor,       # (B, N) f32 in {+1, -1, 0}
    nv: torch.Tensor,      # (B,) f32 valid row counts (≥ 1)
    w: torch.Tensor,       # (B, d) stage-entry separator
    b: torch.Tensor,       # (B,)
    lam: torch.Tensor,     # (B,) per-instance stage λ
    found: torch.Tensor,   # (B,) bool first-0-error latch state in
    w_best: torch.Tensor,  # (B, d) latched separator in
    b_best: torch.Tensor,  # (B,)
    *,
    nsteps: int,
    t0: float = 0.0,
    skip_latched: bool = False,
):
    """One fused Pegasos λ stage + first-0-error latch: ``nsteps`` masked
    hinge-gradient updates with step size ``1/(λ(s+2+t0))`` and the
    ``1/sqrt(λ)`` ball projection, then the min-margin scan (``BIG`` where
    an instance has no valid rows) folded into the latch.  Returns
    ``(w, b, mmin, found, w_best, b_best)``, as
    ``ref.pegasos_stage_batch_ref`` of the JAX package does.

    ``skip_latched=True`` leaves an instance that enters latched
    (``found``) at its entry (w, b): the solver discards such an
    instance's later iterates anyway, and the kernel skips their steps.
    """
    valid = y != 0
    w_in, b_in = w, b
    inv_sqrt_lam = 1.0 / sqrt_rn(lam)
    for s in range(nsteps):
        m = y * decide(X, w, b)
        vy = ((m < 1.0) & valid).to(X.dtype) * y
        g = block_sum(vy[:, :, None] * X)                        # (B, d)
        gb = -vy.sum(dim=1) / nv
        c = float(np.float32(s) + np.float32(2.0) + np.float32(t0))
        eta = 1.0 / (lam * c)
        w2 = w - eta[:, None] * (lam[:, None] * w - g / nv[:, None])
        b2 = b - eta * gb
        nrm2 = w2[:, 0] * w2[:, 0]
        for i in range(1, w2.shape[1]):
            nrm2 = nrm2 + w2[:, i] * w2[:, i]
        scale = torch.clamp(inv_sqrt_lam / (sqrt_rn(nrm2) + 1e-12),
                            max=1.0)
        w, b = w2 * scale[:, None], b2 * scale
    if skip_latched:
        w = torch.where(found[:, None], w_in, w)
        b = torch.where(found, b_in, b)
    m = y * decide(X, w, b)
    mmin = torch.where(valid, m, BIG).amin(dim=1)
    ok = mmin > 0.0
    take = ok & ~found
    return (w, b, mmin, found | ok,
            torch.where(take[:, None], w, w_best),
            torch.where(take, b, b_best))


def stage_plan_ok(d: int, warps: int) -> bool:
    """Whether the stage kernel launches ``warps`` instances a block at
    dimension ``d``: above ``SMALL_D`` each warp keeps w and its gradient
    (2d floats) in the block's shared memory."""
    return warps in WARPS and (
        d <= SMALL_D or warps * 2 * d * 4 <= bounds.SMEM_PER_BLOCK)


def _bound() -> ctypes.CDLL:
    lib = _build.load("pegasos_stage")
    fn = lib.pegasos_stage_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 15 + [ctypes.c_int] * 5 + \
        [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    return lib


def pegasos_stage(X, y, nv, w, b, lam, found, w_best, b_best, *, nsteps,
                  t0=0.0, skip_latched=False, plan=None):
    """The stage of :func:`pegasos_stage_plain`.  CUDA tensors launch the
    kernel of ``csrc/pegasos_stage.cu`` (and count the launch in
    ``pegasos_stage.launches``) with ``plan`` (``{"warps": 1|2|4|8}``
    instances a block, each a warp: every plan gives the same bits;
    default: the tuning cache's, else the kernel's own 4); CPU tensors
    take the plain version."""
    if X.device.type == "cpu":
        return pegasos_stage_plain(X, y, nv, w, b, lam, found, w_best,
                                   b_best, nsteps=nsteps, t0=t0,
                                   skip_latched=skip_latched)
    if X.device.type != "cuda":
        raise ValueError(f"pegasos_stage runs on cuda or cpu, not {X.device}")
    B, N, d = X.shape
    if not (B > 0 and N > 0 and 0 < d <= _MAX_D and nsteps >= 0):
        raise ValueError(f"pegasos_stage: unsupported shape B={B}, N={N}, "
                         f"d={d}, nsteps={nsteps}")
    dev = X.device
    f32 = torch.float32
    _require(X, "X", f32, (B, N, d), dev)
    _require(y, "y", f32, (B, N), dev)
    for t, name in ((nv, "nv"), (b, "b"), (lam, "lam"), (b_best, "b_best")):
        _require(t, name, f32, (B,), dev)
    _require(w, "w", f32, (B, d), dev)
    _require(w_best, "w_best", f32, (B, d), dev)
    _require(found, "found", torch.bool, (B,), dev)
    outs = (torch.empty((B, d), dtype=f32, device=dev),
            torch.empty((B,), dtype=f32, device=dev),
            torch.empty((B,), dtype=f32, device=dev),
            torch.empty((B,), dtype=torch.bool, device=dev),
            torch.empty((B, d), dtype=f32, device=dev),
            torch.empty((B,), dtype=f32, device=dev))
    if plan is None:
        plan = autotune.plan_for("pegasos_stage", dev, B, N, d)
    lib = _bound()
    with torch.cuda.device(dev):
        err = lib.pegasos_stage_launch(
            *(t.data_ptr() for t in (X, y, nv, w, b, lam, found, w_best,
                                     b_best)),
            *(t.data_ptr() for t in outs), B, N, d, nsteps,
            int(skip_latched), float(np.float32(t0)),
            0 if plan is None else plan["warps"],
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, "pegasos_stage", err)
    pegasos_stage.launches += 1
    return outs


pegasos_stage.launches = 0
