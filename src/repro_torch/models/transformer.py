"""Block assembly and the layer stack.

Counterpart of ``repro.models.transformer``.  A *period* is a tuple of
(mixer, ffn) descriptors (len 1 for homogeneous models).  The JAX package
stacks every period's parameters on a leading ``n_periods`` axis for
``lax.scan``; here the stack is a list of per-layer parameter dicts, layer
``i * len(period) + j`` holding period ``i``'s position ``j``, and a Python
loop walks it.  Caches are one dict per layer, preallocated and written in
place.  As in the JAX package, the residual stream's batch axis is pinned
to the data mesh axes after the mixer and after the FFN, and at the start
of each period (``distribution.constraints.constrain_batch_dim``: on a
mesh a DTensor is redistributed there, a row-parallel output's partial
sums reduced; without a mesh, or on a plain tensor, the identity).

Every layer kind of the JAX package is ported: attention, MLA, Mamba and
RWKV-6 mixers, and SwiGLU, GELU, MoE and RWKV channel-mix FFNs (the SSM
states and MLA's latents are caches like the attention keys and values,
written in place).  A layer returns its MoE aux loss (0 for other FFNs)
and the stack sums them, as the JAX package's scan does.

``apply_stack(remat=True)`` under autograd keeps only each layer's input
for the backward pass and runs the layer again there
(``torch.utils.checkpoint``), the counterpart of the JAX package's
``jax.checkpoint`` over each period and each layer inside a multi-layer
period.  A recomputed SSM layer launches its scan kernel again.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.distribution.constraints import (constrain_batch_dim,
                                                  gather_fsdp)
from repro_torch.kernels._grad import needs_grad
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (
    apply_attention,
    apply_mla,
    apply_mlp,
    checkpointed,
    init_attention,
    init_mla,
    init_mlp,
    rmsnorm,
)

Params = Dict[str, Any]

_MIXERS = ("attn", "mla", "mamba", "rwkv")
_FFNS = ("mlp", "gelu_mlp", "moe", "rwkv_cmix")


def check_ported(cfg: ModelConfig, period=None) -> None:
    """Raise ``ValueError`` if a layer of ``period`` (default the config's)
    is of a kind the JAX package does not know either."""
    for mixer, ffn in (period if period is not None else cfg.period):
        if mixer not in _MIXERS or ffn not in _FFNS:
            raise ValueError(f"{cfg.name}: unknown layer ({mixer}, {ffn})")


# ---------------------------------------------------------------------------
# single layer
# ---------------------------------------------------------------------------

def init_layer(gen: torch.Generator, cfg: ModelConfig, mixer: str, ffn: str,
               dtype, with_cross: bool = False) -> Params:
    check_ported(cfg, ((mixer, ffn),))
    d = cfg.d_model
    ones = lambda: torch.ones((d,), dtype=dtype, device=gen.device)  # noqa: E731
    p: Params = {"mixer_norm": ones(), "ffn_norm": ones()}
    if mixer == "attn":
        p["mixer"] = init_attention(gen, cfg, dtype)
    elif mixer == "mla":
        p["mixer"] = init_mla(gen, cfg, dtype)
    elif mixer == "mamba":
        p["mixer"] = ssm.init_mamba(gen, cfg, dtype)
    else:
        p["mixer"] = ssm.init_rwkv_tmix(gen, cfg, dtype)
    if ffn == "moe":
        p["ffn"] = moe_mod.init_moe(gen, cfg, dtype)
    elif ffn == "rwkv_cmix":
        p["ffn"] = ssm.init_rwkv_cmix(gen, cfg, dtype)
    else:
        p["ffn"] = init_mlp(gen, d, cfg.d_ff, ffn, dtype)
    if with_cross:
        p["cross"] = init_attention(gen, cfg, dtype)
        p["cross_norm"] = ones()
    return p


def layer_cache_init(cfg: ModelConfig, mixer: str, ffn: str, batch: int,
                     cache_len: int, dtype, with_cross: bool = False,
                     enc_len: int = 0, device=None) -> Params:
    """Decode-time state for one layer (zeros, written in place later):
    keys and values for attention, the latents ``ckv`` and rope keys
    ``krope`` for MLA, ``conv`` / ``h`` for Mamba,
    ``tmix_shift`` / ``tmix_wkv`` for the RWKV time mix and ``cmix_shift``
    for its channel mix; the recurrent states ``h`` and ``tmix_wkv`` in
    f32, the rest in ``dtype``."""
    check_ported(cfg, ((mixer, ffn),))
    c: Params = {}
    if mixer == "attn":
        shape = (batch, cache_len, cfg.n_kv, cfg.hd)
        c["k"] = torch.zeros(shape, dtype=dtype, device=device)
        c["v"] = torch.zeros(shape, dtype=dtype, device=device)
    elif mixer == "mla":
        m = cfg.mla
        c["ckv"] = torch.zeros((batch, cache_len, m.kv_lora), dtype=dtype,
                               device=device)
        c["krope"] = torch.zeros((batch, cache_len, m.qk_rope_dim),
                                 dtype=dtype, device=device)
    elif mixer == "mamba":
        c.update(ssm.mamba_state_init(cfg, batch, dtype, device))
    else:
        c.update({"tmix_" + k: v for k, v in ssm.rwkv_tmix_state_init(
            cfg, batch, dtype, device).items()})
    if ffn == "rwkv_cmix":
        c["cmix_shift"] = ssm.rwkv_cmix_state_init(cfg, batch, dtype,
                                                   device)["shift"]
    if with_cross:
        cross = (batch, enc_len, cfg.n_kv, cfg.hd)
        c["cross_k"] = torch.zeros(cross, dtype=dtype, device=device)
        c["cross_v"] = torch.zeros(cross, dtype=dtype, device=device)
    return c


def apply_layer(
    p: Params,
    cfg: ModelConfig,
    mixer: str,
    ffn: str,
    x: torch.Tensor,
    positions: torch.Tensor,
    *,
    causal: bool = True,
    window: Optional[int] = None,
    cache: Optional[Params] = None,
    cache_index: Optional[int] = None,
    cross_y: Optional[torch.Tensor] = None,
    mla_absorb: bool = False,
    block_q: int = 1024,
) -> Tuple[torch.Tensor, Optional[Params], torch.Tensor]:
    """Pre-norm residual layer.  Returns (x, cache, aux_loss); the cache is
    the one given, written in place (None without one)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if needs_grad(x):     # training: FSDP's weights gathered here
        p = gather_fsdp(p)

    h = rmsnorm(x, p["mixer_norm"], cfg.norm_eps)
    if mixer == "attn":
        h, _ = apply_attention(p["mixer"], cfg, h, positions, causal=causal,
                               window=window, cache=cache,
                               cache_index=cache_index, block_q=block_q)
    elif mixer == "mla":
        h, _ = apply_mla(p["mixer"], cfg, h, positions, window=window,
                         cache=cache, cache_index=cache_index,
                         absorb=mla_absorb, block_q=block_q)
    elif mixer == "mamba":
        st = None if cache is None else {"conv": cache["conv"],
                                         "h": cache["h"]}
        h, _ = ssm.apply_mamba(p["mixer"], cfg, h, st)
    else:
        st = None if cache is None else {"shift": cache["tmix_shift"],
                                         "wkv": cache["tmix_wkv"]}
        h, _ = ssm.apply_rwkv_tmix(p["mixer"], cfg, h, st)
    # pin the residual stream to (batch=data axes, seq/d replicated): the
    # row-parallel output's partial sums are reduced here, and the FFN (the
    # MoE dispatch above all) never sees a d-sharded stream
    x = constrain_batch_dim(x + h)

    if "cross" in p:
        h = rmsnorm(x, p["cross_norm"], cfg.norm_eps)
        if cache is not None and "cross_k" in cache and cross_y is None:
            h, _ = apply_attention(
                p["cross"], cfg, h, positions,
                kv_override=(cache["cross_k"], cache["cross_v"]),
                block_q=block_q)
        else:
            h, cc = apply_attention(p["cross"], cfg, h, positions,
                                    cross_y=cross_y, block_q=block_q)
            if cache is not None:
                for name, t in (("cross_k", cc["k"]), ("cross_v", cc["v"])):
                    if cache[name].shape == t.shape:
                        cache[name].copy_(t)
                    else:   # another encoder length: replaced, as in JAX
                        cache[name] = t.to(cache[name].dtype)
        x = x + h

    h = rmsnorm(x, p["ffn_norm"], cfg.norm_eps)
    if ffn == "moe":
        h, aux = moe_mod.apply_moe(p["ffn"], cfg, h)
    elif ffn == "rwkv_cmix":
        st = None if cache is None else {"shift": cache["cmix_shift"]}
        h, _ = ssm.apply_rwkv_cmix(p["ffn"], cfg, h, st)
    else:
        h = apply_mlp(p["ffn"], h, ffn)
    x = constrain_batch_dim(x + h)
    return x, cache, aux


# ---------------------------------------------------------------------------
# the stack
# ---------------------------------------------------------------------------

def init_stack(gen: torch.Generator, cfg: ModelConfig, dtype, *, period=None,
               n_periods=None, with_cross: bool = False) -> List[Params]:
    """Per-layer params, layer ``i * len(period) + j`` = period i, pos j."""
    period = period if period is not None else cfg.period
    n_periods = n_periods if n_periods is not None else cfg.n_layers // len(period)
    return [init_layer(gen, cfg, mixer, ffn, dtype, with_cross=with_cross)
            for _ in range(n_periods) for mixer, ffn in period]


def stack_cache_init(cfg: ModelConfig, batch: int, cache_len: int, dtype, *,
                     period=None, n_periods=None, with_cross=False,
                     enc_len=0, device=None) -> List[Params]:
    period = period if period is not None else cfg.period
    n_periods = n_periods if n_periods is not None else cfg.n_layers // len(period)
    return [layer_cache_init(cfg, mixer, ffn, batch, cache_len, dtype,
                             with_cross=with_cross, enc_len=enc_len,
                             device=device)
            for _ in range(n_periods) for mixer, ffn in period]


def apply_stack(
    params: List[Params],
    cfg: ModelConfig,
    x: torch.Tensor,
    positions: torch.Tensor,
    *,
    period=None,
    causal: bool = True,
    window: Optional[int] = None,
    caches: Optional[List[Params]] = None,
    cache_index: Optional[int] = None,
    cross_y: Optional[torch.Tensor] = None,
    mla_absorb: bool = False,
    block_q: int = 1024,
    remat: bool = False,
) -> Tuple[torch.Tensor, Optional[List[Params]], torch.Tensor]:
    """Run every layer in order.  Returns (x, caches, aux); the caches are
    the ones given, written in place.  ``remat`` (without caches, under
    autograd) recomputes each layer in the backward pass."""
    period = period if period is not None else cfg.period
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    remat = remat and caches is None and torch.is_grad_enabled()
    for i, layer_p in enumerate(params):
        mixer, ffn = period[i % len(period)]
        if i % len(period) == 0:
            x = constrain_batch_dim(x)  # keep batch pinned to the data axes
        x, _, a = checkpointed(
            apply_layer, layer_p, cfg, mixer, ffn, x, positions, on=remat,
            causal=causal, window=window,
            cache=caches[i] if caches is not None else None,
            cache_index=cache_index, cross_y=cross_y, mla_absorb=mla_absorb,
            block_q=block_q)
        aux = aux + a
    return x, caches, aux
