"""State-space / recurrent mixers: Mamba-1 selective SSM and RWKV-6 (Finch).

Counterpart of ``repro.models.ssm``.  Each ``apply_*`` takes a whole
sequence (scoring, or prefill continuing from a carried state) or, with a
state and S = 1, one decoded token.  The JAX package runs both recurrences
as a ``lax.scan`` through ``chunked_scan``; here they go to the port's
kernels, :func:`repro_torch.kernels.rwkv6` and
:func:`repro_torch.kernels.mamba_scan` (the CUDA kernels for tensors on the
card, their plain versions on the CPU), which compute the same step.
Under autograd (an input requires a gradient) they go to
``kernels.rwkv6_autograd`` / ``kernels.mamba_scan_autograd`` instead: the
same launch forward, and backward the counterpart of JAX's
``chunked_scan``, the plain recurrence recomputed and differentiated in
64-token chunks.  Training carries no state, so a call with a state
under autograd raises.

A ``state`` is a dict of preallocated tensors (the layer's serving cache)
and is written in place; the returned state is the same dict.

On a mesh (DTensor activations) each rank launches the kernel on its own
shard (``local_call``): its batch rows on the data axes and its heads
(WKV) or channels (scan) on the model axis where that axis divides them,
the same call per rank as on one device.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch import kernels
from repro_torch.distribution.constraints import (
    axes_of,
    batch_entry,
    constrain,
    is_dtensor,
    local_call,
    model_entry,
    whole,
)
from repro_torch.kernels._grad import needs_grad
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import dense_init, rmsnorm, split_heads

Params = Dict[str, Any]


def _stateless(state, what: str) -> None:
    if state is not None:
        raise RuntimeError(f"{what}: no gradient through a carried state; "
                           f"training runs without caches")


# ===========================================================================
# Mamba-1 selective SSM (Jamba's mixer)
# ===========================================================================

def mamba_dims(cfg: ModelConfig) -> Tuple[int, int, int, int]:
    s = cfg.ssm
    di = s.expand * cfg.d_model
    dtr = s.dt_rank or -(-cfg.d_model // 16)
    return di, s.d_state, s.d_conv, dtr


def init_mamba(gen: torch.Generator, cfg: ModelConfig,
               dtype=torch.float32) -> Params:
    d = cfg.d_model
    di, ds, dc, dtr = mamba_dims(cfg)
    dev = gen.device
    a_log = torch.log(torch.arange(1, ds + 1, dtype=torch.float32,
                                   device=dev)).expand(di, ds)
    return {
        "in_x": dense_init(gen, d, di, dtype),
        "in_z": dense_init(gen, d, di, dtype),
        "conv_w": (torch.randn((dc, di), generator=gen, device=dev)
                   / math.sqrt(dc)).to(dtype),
        "conv_b": torch.zeros((di,), dtype=dtype, device=dev),
        "x_proj": dense_init(gen, di, dtr + 2 * ds, dtype),
        "dt_proj": dense_init(gen, dtr, di, dtype),
        "dt_bias": torch.full((di,), -4.6, dtype=dtype, device=dev),
        "A_log": a_log.to(dtype).contiguous(),
        "D": torch.ones((di,), dtype=dtype, device=dev),
        "out_proj": dense_init(gen, di, d, dtype),
    }


def _pad_front(x: torch.Tensor, n: int) -> torch.Tensor:
    """(B, S, d) with ``n`` zero steps in front.  A DTensor is joined to
    zeros instead of padded (DTensor's padding on torch 2.11 fails to plan
    its redistribution); the values are the same."""
    if not is_dtensor(x):
        return F.pad(x, (0, 0, n, 0))
    return torch.cat([torch.zeros_like(x[:, :1]).expand(-1, n, -1), x],
                     dim=1)


def _mamba_conv_full(xs: torch.Tensor, w: torch.Tensor,
                     b: torch.Tensor) -> torch.Tensor:
    """Causal depthwise conv over time. xs: (B, S, di), w: (dc, di)."""
    dc, S = w.shape[0], xs.shape[1]
    pad = _pad_front(xs, dc - 1)
    out = torch.zeros_like(xs)
    for i in range(dc):   # dc is 4: four shifted adds, as in the JAX package
        out = out + pad[:, i:i + S, :] * w[i]
    return out + b


def _mamba_ssm_inputs(p: Params, cfg: ModelConfig, xc: torch.Tensor):
    """From conv'd activations to (Δ, B, C) selective parameters,
    contiguous, as the scan kernel takes them."""
    di, ds, _, dtr = mamba_dims(cfg)
    # on a mesh the product's sums over the split channels are reduced
    # here, before the nonlinearities
    proj = constrain(xc @ p["x_proj"], batch_entry(xc.shape[0]), None, None) \
        if is_dtensor(xc) else xc @ p["x_proj"]
    dt, Bs, Cs = proj.split([dtr, ds, ds], dim=-1)
    delta = F.softplus(dt @ p["dt_proj"] + p["dt_bias"].to(dt.dtype))
    return delta.contiguous(), Bs.contiguous(), Cs.contiguous()


def apply_mamba(
    p: Params,
    cfg: ModelConfig,
    x: torch.Tensor,                     # (B, S, d)
    state: Optional[Params] = None,  # {"conv": (B,dc-1,di), "h": (B,di,ds)}
) -> Tuple[torch.Tensor, Optional[Params]]:
    S = x.shape[1]
    di, ds, dc, dtr = mamba_dims(cfg)
    xin = x @ p["in_x"]
    z = x @ p["in_z"]

    if state is None or S > 1:
        # scoring, or prefill continuing from a carried state
        if state is not None:
            pad = torch.cat([state["conv"].to(xin.dtype), xin], dim=1)
            xc = _mamba_conv_full(pad, p["conv_w"], p["conv_b"])[:, dc - 1:]
        else:
            xc = _mamba_conv_full(xin, p["conv_w"], p["conv_b"])
        xc = F.silu(xc)
    else:
        # decode: one token against the carried conv window
        window = torch.cat([state["conv"].to(xin.dtype), xin], dim=1)
        xc = F.silu(torch.einsum("bci,ci->bi", window, p["conv_w"])
                    + p["conv_b"])[:, None, :]
    # the scan kernel takes contiguous tensors; the einsum's result may come
    # back transposed on the card
    xc = xc.contiguous()
    delta, Bs, Cs = _mamba_ssm_inputs(p, cfg, xc)
    A = -torch.exp(p["A_log"].float())                  # (di, ds)
    y = _scan(xc, delta, A, Bs, Cs, None if state is None else state["h"])
    y = y + xc * p["D"].to(xc.dtype)
    out = (y * F.silu(z)) @ p["out_proj"]
    if state is not None:
        conv = state["conv"]
        conv.copy_(torch.cat([conv.to(xin.dtype), xin],
                             dim=1)[:, -(dc - 1):, :])
    return out, state


def _scan_call(xc, delta, A, Bs, Cs, h):
    if needs_grad(xc, delta, A, Bs, Cs):
        _stateless(h, "apply_mamba")
        return kernels.mamba_scan_autograd(xc, delta, A, Bs, Cs)
    return kernels.mamba_scan(xc, delta, A, Bs, Cs, state=h)


def _scan(xc, delta, A, Bs, Cs, h) -> torch.Tensor:
    """The selective scan's y; on a mesh each rank scans its batch rows
    and channels (Bs, Cs whole: their gradients are partial sums over the
    channels' ranks, A's over the batch's)."""
    if not is_dtensor(xc):
        return _scan_call(xc, delta, A, Bs, Cs, h)[0]
    b, c = batch_entry(xc.shape[0]), model_entry(xc.shape[2])
    seq, bsc, st = (b, None, c), (b, None, None), (b, c, None)
    y, _ = local_call(
        _scan_call, (xc, delta, A, Bs, Cs, h),
        (seq, seq, (c, None), bsc, bsc, None if h is None else st),
        [(seq, ()), (st, ())],
        grad_partial=[(), (), axes_of(b), axes_of(c), axes_of(c), ()])
    return y


def mamba_state_init(cfg: ModelConfig, batch: int, dtype=torch.float32,
                     device=None) -> Params:
    di, ds, dc, _ = mamba_dims(cfg)
    return {"conv": torch.zeros((batch, dc - 1, di), dtype=dtype,
                                device=device),
            "h": torch.zeros((batch, di, ds), dtype=torch.float32,
                             device=device)}


# ===========================================================================
# RWKV-6 "Finch" time-mix + channel-mix
# ===========================================================================

def rwkv_dims(cfg: ModelConfig) -> Tuple[int, int]:
    hd = cfg.rwkv.head_dim
    assert cfg.d_model % hd == 0
    return cfg.d_model // hd, hd


def init_rwkv_tmix(gen: torch.Generator, cfg: ModelConfig,
                   dtype=torch.float32) -> Params:
    d = cfg.d_model
    H, hd = rwkv_dims(cfg)
    lora = cfg.rwkv.decay_lora
    dev = gen.device

    def full(value):
        return torch.full((d,), value, dtype=dtype, device=dev)

    # static token-shift mixes and the decay LoRA, as in the JAX package
    return {
        "mu_r": full(0.5), "mu_k": full(0.5), "mu_v": full(0.5),
        "mu_w": full(0.5), "mu_g": full(0.5),
        "wr": dense_init(gen, d, d, dtype), "wk": dense_init(gen, d, d, dtype),
        "wv": dense_init(gen, d, d, dtype), "wg": dense_init(gen, d, d, dtype),
        "wo": dense_init(gen, d, d, dtype),
        # data-dependent decay LoRA:  w_t = exp(-exp(w0 + tanh(x̃ A) B))
        "w0": full(-2.0),
        "wA": dense_init(gen, d, lora, dtype),
        "wB": dense_init(gen, lora, d, dtype, scale=0.01),
        "u": (torch.randn((H, hd), generator=gen, device=dev)
              * 0.1).to(dtype),
        "ln_scale": full(1.0),
    }


def _token_shift(x: torch.Tensor, prev: Optional[torch.Tensor]
                 ) -> torch.Tensor:
    """x_{t-1} stream: zeros (or the carried last token) at t=0."""
    if prev is None:
        return _pad_front(x, 1)[:, :-1, :]
    if is_dtensor(prev):    # the cached token in the stream's layout
        prev = constrain(prev, batch_entry(prev.shape[0]), None)
    return torch.cat([prev[:, None, :].to(x.dtype), x[:, :-1, :]], dim=1)


def _rwkv_gates(p: Params, cfg: ModelConfig, x: torch.Tensor,
                xprev: torch.Tensor):
    H, hd = rwkv_dims(cfg)

    def mix(mu):
        return x + (xprev - x) * whole(mu).to(x.dtype)

    r = split_heads(mix(p["mu_r"]) @ p["wr"], H, hd)
    k = split_heads(mix(p["mu_k"]) @ p["wk"], H, hd)
    v = split_heads(mix(p["mu_v"]) @ p["wv"], H, hd)
    g = F.silu(mix(p["mu_g"]) @ p["wg"])
    logw = whole(p["w0"]).float() + torch.tanh(
        mix(p["mu_w"]).float() @ p["wA"].float()) @ p["wB"].float()
    w = split_heads(torch.exp(-torch.exp(logw)), H, hd)  # decay in (0, 1)
    return r, k, v, g, w


def apply_rwkv_tmix(
    p: Params,
    cfg: ModelConfig,
    x: torch.Tensor,
    state: Optional[Params] = None,  # {"shift": (B,d), "wkv": (B,H,hd,hd)}
) -> Tuple[torch.Tensor, Optional[Params]]:
    B, S, d = x.shape
    H, hd = rwkv_dims(cfg)
    xprev = _token_shift(x, None if state is None else state["shift"])
    r, k, v, g, w = _rwkv_gates(p, cfg, x, xprev)
    # the recurrence in f32, as the JAX package casts before its scan: the
    # kernel widens r, k and v from the model's dtype itself (exactly, so
    # the function is the same); w is f32 already
    u = p["u"].float()
    y = _wkv(r, k, v, w, u, None if state is None else state["wkv"])
    # per-head group norm
    y = rmsnorm(y, torch.ones((hd,), dtype=x.dtype, device=x.device),
                cfg.norm_eps).reshape(B, S, d)
    y = y * whole(p["ln_scale"]).to(x.dtype)
    out = (y.to(x.dtype) * g) @ p["wo"]
    if state is not None:
        state["shift"].copy_(x[:, -1, :])
    return out, state


def _wkv_call(r, k, v, w, u, wkv):
    if needs_grad(r, k, v, w, u):
        _stateless(wkv, "apply_rwkv_tmix")
        return kernels.rwkv6_autograd(r, k, v, w, u)
    return kernels.rwkv6(r, k, v, w, u, state=wkv)


def _wkv(r, k, v, w, u, wkv) -> torch.Tensor:
    """The WKV recurrence's y; on a mesh each rank runs its batch rows and
    heads (u's gradient a partial sum over the batch's ranks)."""
    if not is_dtensor(r):
        return _wkv_call(r, k, v, w, u, wkv)[0]
    b, h = batch_entry(r.shape[0]), model_entry(r.shape[2])
    seq, st = (b, None, h, None), (b, h, None, None)
    y, _ = local_call(
        _wkv_call, (r, k, v, w, u, wkv),
        (seq, seq, seq, seq, (h, None), None if wkv is None else st),
        [(seq, ()), (st, ())],
        grad_partial=[(), (), (), (), axes_of(b), ()])
    return y


def rwkv_tmix_state_init(cfg: ModelConfig, batch: int, dtype=torch.float32,
                         device=None) -> Params:
    H, hd = rwkv_dims(cfg)
    return {"shift": torch.zeros((batch, cfg.d_model), dtype=dtype,
                                 device=device),
            "wkv": torch.zeros((batch, H, hd, hd), dtype=torch.float32,
                               device=device)}


def init_rwkv_cmix(gen: torch.Generator, cfg: ModelConfig,
                   dtype=torch.float32) -> Params:
    d, ff = cfg.d_model, cfg.d_ff
    half = torch.full((d,), 0.5, dtype=dtype, device=gen.device)
    return {
        "mu_k": half, "mu_r": half.clone(),
        "wk": dense_init(gen, d, ff, dtype),
        "wv": dense_init(gen, ff, d, dtype),
        "wr": dense_init(gen, d, d, dtype),
    }


def apply_rwkv_cmix(
    p: Params,
    cfg: ModelConfig,
    x: torch.Tensor,
    state: Optional[Params] = None,  # {"shift": (B,d)}
) -> Tuple[torch.Tensor, Optional[Params]]:
    xprev = _token_shift(x, None if state is None else state["shift"])

    def mix(mu):
        return x + (xprev - x) * whole(mu).to(x.dtype)

    k = torch.square(F.relu(mix(p["mu_k"]) @ p["wk"]))
    r = torch.sigmoid(mix(p["mu_r"]) @ p["wr"])
    out = r * (k @ p["wv"])
    if state is not None:
        state["shift"].copy_(x[:, -1, :])
    return out, state


def rwkv_cmix_state_init(cfg: ModelConfig, batch: int, dtype=torch.float32,
                         device=None) -> Params:
    return {"shift": torch.zeros((batch, cfg.d_model), dtype=dtype,
                                 device=device)}
