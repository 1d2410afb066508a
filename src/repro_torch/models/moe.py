"""Mixture-of-Experts FFN: top-k routing, capacity-bounded sort-based
dispatch, optional shared experts (DeepSeek-V2 style), load-balance
auxiliary loss.

Counterpart of ``repro.models.moe``.  Tokens are expanded top-k ways, sorted
by expert id per batch row (a stable sort, as ``jnp.argsort``), ranked within
their expert's segment and written into a dense (B, E, capacity, d) buffer
that feeds one batched product per projection; slots past an expert's
capacity are dropped, the earliest tokens of a segment kept.  The expert
products are plain PyTorch matmuls, as the JAX package computes them
outside any Pallas kernel.

On a mesh (DTensor activations) the routed part runs on each rank's own
rows (``local_call``), as the JAX package's pins of ``x``, ``st``,
``src``, the dispatch buffer and ``out`` to the batch axes ask GSPMD to:
routing and dispatch are local to a data rank; when the model axis
divides the experts each rank holds and computes its own experts (expert
parallel), else its slice of each expert's hidden width, and the combine
is a partial sum over the model axis, reduced where the residual stream
is pinned.  The load-balance loss is formed from the ranks' mean router
probabilities and expert counts.

Few-token calls (``B·S <= 16``, decode) take the gather path: each token's
top-k experts applied to it directly.  The JAX package gathers a
(T, K, d, d_expert) copy of the picked weights; here each distinct picked
expert's weights are applied, as they lie, to the tokens that picked it,
the same per-(token, pick) products without the copy.
"""

from __future__ import annotations

import math
from typing import Any, Dict, NamedTuple, Tuple

import torch
import torch.nn.functional as F

from repro_torch.distribution.constraints import (
    axes_of,
    batch_entry,
    constrain,
    constrain_batch_dim,
    is_dtensor,
    local_call,
    model_axis_size,
    reduce_over,
    shard_index,
    spec_now,
)
from repro_torch.kernels._ops import is_fake
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import dense_init

Params = Dict[str, Any]


class Routing(NamedTuple):
    """The dispatch plan of one :func:`route` call, batch rows first.

    ``gate_vals`` (B, S, K) f32 renormalised top-k probabilities and
    ``expert_ids`` (B, S, K) their experts, highest first; ``order`` (B,
    S·K) the stable sort of the flattened picks by expert; ``keep`` and
    ``dest`` (B, S·K), in that sorted order, whether a slot fits its
    expert's capacity and its row in the (E·cap) buffer (0 within the
    expert's block where dropped); ``aux`` the load-balance loss."""
    gate_vals: torch.Tensor
    expert_ids: torch.Tensor
    keep: torch.Tensor
    dest: torch.Tensor
    aux: torch.Tensor
    order: torch.Tensor


def moe_capacity(cfg: ModelConfig, n_tokens: int) -> int:
    mo = cfg.moe
    if n_tokens * mo.top_k <= 256:
        # tiny sequences (smoke tests, small decode batches): drop-free
        # capacity so the dense dispatch agrees exactly with the gather path
        return n_tokens * mo.top_k
    cap = int(math.ceil(n_tokens * mo.top_k / mo.n_experts
                        * mo.capacity_factor))
    # round up to a lane-friendly multiple
    return max(8, -(-cap // 8) * 8)


def init_moe(gen: torch.Generator, cfg: ModelConfig,
             dtype=torch.float32) -> Params:
    mo = cfg.moe
    d, ffe, E = cfg.d_model, mo.d_expert, mo.n_experts

    def experts(d_in, d_out):
        w = torch.randn((E, d_in, d_out), generator=gen, device=gen.device,
                        dtype=torch.float32)
        return (w / math.sqrt(d_in)).to(dtype)

    # separate gate / up per expert, as the JAX package keeps them; down
    # (E, ffe, d)
    p = {"router": dense_init(gen, d, E, dtype, scale=0.02),
         "we_g": experts(d, ffe), "we_u": experts(d, ffe),
         "we_o": experts(ffe, d)}
    if mo.n_shared:
        p["shared_wg"] = dense_init(gen, d, ffe * mo.n_shared, dtype)
        p["shared_wu"] = dense_init(gen, d, ffe * mo.n_shared, dtype)
        p["shared_wo"] = dense_init(gen, ffe * mo.n_shared, d, dtype)
    return p


def _top_k(p: Params, cfg: ModelConfig, x: torch.Tensor):
    """Router softmax over the last axis; returns (probs, renormalised
    top-k gates, expert ids), the gates and probabilities in f32."""
    logits = (x @ p["router"]).float()
    probs = torch.softmax(logits, dim=-1)
    gate_vals, expert_ids = torch.topk(probs, cfg.moe.top_k, dim=-1)
    gate_vals = gate_vals / (gate_vals.sum(-1, keepdim=True) + 1e-9)
    return probs, gate_vals, expert_ids


def route(p: Params, cfg: ModelConfig, x: torch.Tensor) -> Routing:
    """Top-k routing of ``x`` (B, S, d) and its per-row dispatch into
    ``moe_capacity(cfg, S)`` slots an expert (see :class:`Routing`)."""
    mo = cfg.moe
    B, S, _ = x.shape
    E, K = mo.n_experts, mo.top_k
    cap = moe_capacity(cfg, S)
    probs, gate_vals, expert_ids = _top_k(p, cfg, x)

    # load-balance aux loss (Switch/GShard form), global means
    me = probs.mean(dim=(0, 1))                                # (E,)
    ce = torch.zeros((E,), dtype=torch.float32, device=x.device)
    ce.index_add_(0, expert_ids.reshape(-1),
                  torch.full((B * S * K,), 1.0 / (B * S * K),
                             dtype=torch.float32, device=x.device))
    aux = E * torch.sum(me * ce) * mo.router_aux_weight

    # per-row sort of the S·K slots by expert; the sort is stable, so a
    # segment keeps its tokens in order and drops the latest past ``cap``
    TK = S * K
    flat_e = expert_ids.reshape(B, TK)
    order = torch.argsort(flat_e, dim=1, stable=True)
    se = flat_e.gather(1, order)
    seg_start = torch.searchsorted(
        se, torch.arange(E, device=x.device).expand(B, E).contiguous())
    pos_in_e = (torch.arange(TK, device=x.device)[None]
                - seg_start.gather(1, se))
    keep = pos_in_e < cap
    dest = se * cap + torch.where(keep, pos_in_e, 0)
    return Routing(gate_vals, expert_ids, keep, dest, aux, order)


def apply_moe(p: Params, cfg: ModelConfig,
              x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (output (B, S, d), aux load-balance loss scalar).

    Dispatch is per batch row: each row sorts its own S·top_k slots into an
    (E, cap, d) buffer, as in the JAX package."""
    mo = cfg.moe
    B0, S0, d = x.shape
    if S0 == 1 and B0 > 1:
        # decode: the batch *is* the token stream — dispatch it as one row so
        # expert buffers stay (E, cap≈B·K/E) instead of B separate buffers
        x = x.reshape(1, B0, d)
    B, S, _ = x.shape

    if B * S <= 16:
        out, aux = _moe_gather_path(p, cfg, x)
        if is_dtensor(out):     # whole (sums reduced) before the reshape
            out = constrain(out, None, None, None)
        return out.reshape(B0, S0, d), aux

    x = constrain_batch_dim(x)
    if is_dtensor(x):
        out, aux = _mesh_dispatch(p, cfg, x)
    else:
        out, r = _dispatch(p, cfg, x)
        aux = r.aux
    out = constrain_batch_dim(out)
    if mo.n_shared:
        out = out + _shared(p, x)
    return out.reshape(B0, S0, d), aux


def _dispatch(p: Params, cfg: ModelConfig, x: torch.Tensor, e0: int = 0,
              cols=None) -> Tuple[torch.Tensor, Routing]:
    """The routed experts' output for ``x`` (B, S, d) and its routing.
    ``p``'s expert weights may be the slice of experts ``e0 ..`` (expert
    parallel): the buffer then holds those experts only and every other
    slot adds nothing.  ``cols`` as :func:`_gather`'s; the output is as
    wide as ``we_o``'s last dim."""
    mo = cfg.moe
    B, S, d = x.shape
    E, K = mo.n_experts, mo.top_k
    n = p["we_g"].shape[0]                                     # experts held
    cap = moe_capacity(cfg, S)
    r = route(p, cfg, x)
    TK = S * K
    st = torch.div(r.order, K, rounding_mode="floor")          # token of slot
    sg = r.gate_vals.reshape(B, TK).gather(1, r.order)
    keep, dest = r.keep, r.dest
    if n < E:
        held = (dest >= e0 * cap) & (dest < (e0 + n) * cap)
        keep = keep & held
        dest = torch.where(held, dest - e0 * cap, 0)

    # dispatch: every slot adds its token (zero where dropped) at its row;
    # a kept row receives exactly one token, so the adds' order is moot
    src = x.gather(1, st[..., None].expand(B, TK, d))
    src = torch.where(keep[..., None], src, 0)
    rows = (torch.arange(B, device=x.device)[:, None] * (n * cap)
            + dest).reshape(-1)
    xe = torch.zeros((B * n * cap, d), dtype=x.dtype, device=x.device)
    xe.index_add_(0, rows, src.reshape(B * TK, d))
    xe = xe.reshape(B, n, cap, d)

    if cols is not None:
        xe = xe[..., cols[0]:cols[0] + p["we_g"].shape[1]]
    g = torch.einsum("becd,edf->becf", xe, p["we_g"])          # (B, E, cap, ffe)
    u = torch.einsum("becd,edf->becf", xe, p["we_u"])
    if cols is not None and axes_of(cols[1]):
        g, u = reduce_over(torch.stack([g, u]), "sum", cols[1]).unbind(0)
    ye = torch.einsum("becf,efd->becd", F.silu(g) * u, p["we_o"])
    w = ye.shape[-1]
    ye = ye.reshape(B, n * cap, w)

    contrib = ye.gather(1, dest[..., None].expand(B, TK, w))
    contrib = contrib * (sg * keep)[..., None].to(ye.dtype)
    # combine: the slots back in (token, pick) order, each token's K summed
    per_tok = torch.empty_like(contrib).scatter_(
        1, r.order[..., None].expand(B, TK, w), contrib)
    return per_tok.reshape(B, S, K, w).sum(2).to(x.dtype), r


_EXPERT_KEYS = ("router", "we_g", "we_u", "we_o")


def _expert_specs(cfg: ModelConfig):
    """Specs of router, we_g, we_u, we_o on a mesh, FSDP's split gathered:
    the experts on "model" when it divides them, else each expert's hidden
    width when it divides that, else replicated; the router whole."""
    mo, m = cfg.moe, model_axis_size()
    if m and mo.n_experts % m == 0:
        return ((None, None), ("model", None, None), ("model", None, None),
                ("model", None, None))
    f = "model" if m and mo.d_expert % m == 0 else None
    return (None, None), (None, None, f), (None, None, f), (None, f, None)


def _held(p: Params, cfg: ModelConfig, b):
    """How a rank holds the experts for tokens on the batch axes ``b``:
    (in-specs of router, we_g, we_u, we_o; the axes splitting the model
    width that we_g's and we_u's products sum over, reduced before the
    gate's nonlinearity; the output's spec; the axes over which it is a
    partial sum).  Where every rank holds every token (``b`` None: decode)
    the weights stay as the rules placed them, FSDP's split too, and the
    few tokens' activations move; else FSDP's split is gathered
    (:func:`_expert_specs`).  The router is whole."""
    if b is None:
        sg, so = spec_now(p["we_g"]), spec_now(p["we_o"])
        sg = (sg[0], sg[1], so[1])      # the hidden width sliced as we_o's
    else:
        _, sg, _, so = _expert_specs(cfg)
    return (((None, None), sg, sg, so), sg[1], (b, None, so[2]),
            axes_of(so[0]) + axes_of(so[1]))


def _mesh_dispatch(p: Params, cfg: ModelConfig, x: torch.Tensor):
    """:func:`_dispatch` on each rank's rows and experts (or hidden-width
    slice) as :func:`_held` holds them; returns (out, aux), out a partial
    sum over the axes splitting the experts or their widths."""
    mo = cfg.moe
    B, S, _ = x.shape
    b = batch_entry(B)
    specs, cols, os_, part = _held(p, cfg, b)
    xs = (b, None, None)

    def local(x, router, we_g, we_u, we_o):
        lp = dict(router=router, we_g=we_g, we_u=we_u, we_o=we_o)
        e0 = shard_index(specs[1][0]) * we_g.shape[0]
        out, r = _dispatch(lp, cfg, x, e0,
                           cols=(shard_index(cols) * we_g.shape[1], cols))
        counts = (r.expert_ids[..., None] == torch.arange(
            mo.n_experts, device=x.device)).float().sum(dim=(0, 1, 2))
        return out, counts

    # a rank's gradients reach the router and x only through its own
    # experts' slots: partial sums over the axes splitting them
    out, counts = local_call(
        local, (x,) + tuple(p[k] for k in _EXPERT_KEYS), (xs,) + specs,
        [(os_, part), ((None,), axes_of(b))],
        grad_partial=[part + axes_of(cols), axes_of(b) + part]
        + [axes_of(b)] * 3)
    me = torch.softmax((x @ p["router"]).float(), dim=-1).mean(dim=(0, 1))
    ce = counts / (B * S * mo.top_k)
    aux = mo.n_experts * torch.sum(me * ce) * mo.router_aux_weight
    return out, aux


def _shared(p: Params, x: torch.Tensor) -> torch.Tensor:
    return (F.silu(x @ p["shared_wg"]) * (x @ p["shared_wu"])) @ p["shared_wo"]


def _moe_gather_path(p: Params, cfg: ModelConfig, x: torch.Tensor):
    """Few-token path (e.g. batch-1 long-context decode): each token's top-k
    experts applied to it instead of the dense (E, cap) dispatch — E/K× less
    work when almost every expert slot would be padding.  Each distinct
    picked expert's weights are read once, for the tokens that picked it
    (the JAX package gathers a (T, K, d, d_expert) copy instead).  On a
    mesh the expert weights stay as the rules placed them
    (:func:`_mesh_gather`)."""
    B, S, d = x.shape
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    out = _mesh_gather(p, cfg, x) if is_dtensor(x) else _gather(p, cfg, x)
    if cfg.moe.n_shared:
        out = out + _shared(p, x)
    return out, aux


def _mesh_gather(p: Params, cfg: ModelConfig, x: torch.Tensor):
    """:func:`_gather` on a mesh, every rank routing every token with the
    expert weights as :func:`_held` holds them for tokens on no batch
    axis: the rules' placement (experts, hidden width or, under FSDP, the
    model width split), so the few tokens' activations move, never the
    weights."""
    specs, cols, os_, part = _held(p, cfg, None)

    def local(x, router, we_g, we_u, we_o):
        lp = dict(router=router, we_g=we_g, we_u=we_u, we_o=we_o)
        e0 = shard_index(specs[1][0]) * we_g.shape[0]
        return (_gather(lp, cfg, x, e0,
                        cols=(shard_index(cols) * we_g.shape[1], cols)),)

    (out,) = local_call(
        local, (x,) + tuple(p[k] for k in _EXPERT_KEYS),
        ((None, None, None),) + specs, [(os_, part)],
        grad_partial=[part + axes_of(cols), part, (), (), ()])
    return out


def _gather(p: Params, cfg: ModelConfig, x: torch.Tensor, e0: int = 0,
            cols=None) -> torch.Tensor:
    """The routed experts' output of the gather path, from the experts
    ``e0 ..`` that ``p`` holds (all of them by default).  ``cols`` = (c0,
    axes): ``we_g`` / ``we_u`` hold the model width's rows ``c0 ..`` of a
    width split over those mesh axes, so their products are summed over
    them (inside a :func:`local_call`)."""
    B, S, d = x.shape
    n = p["we_g"].shape[0]
    xt = x.reshape(B * S, d)
    _, gate_vals, expert_ids = _top_k(p, cfg, xt)              # (T, K)
    picks = list(_held_picks(cfg, expert_ids, e0, n))
    xw = xt if cols is None else xt[:, cols[0]:cols[0] + p["we_g"].shape[1]]
    gs = [xw[t] @ p["we_g"][e] for e, t, _ in picks]
    us = [xw[t] @ p["we_u"][e] for e, t, _ in picks]
    if cols is not None and axes_of(cols[1]) and picks:
        gu = reduce_over(torch.cat(gs + us), "sum", cols[1])
        rows = [len(t) for _, t, _ in picks]
        parts = gu.split(rows * 2)
        gs, us = parts[:len(picks)], parts[len(picks):]
    width = p["we_o"].shape[2]
    ye = (torch.empty if n == cfg.moe.n_experts and cols is None
          else torch.zeros)((*expert_ids.shape, width), dtype=x.dtype,
                            device=x.device)
    for (e, t, k), g, u in zip(picks, gs, us):
        ye[t, k] = (F.silu(g) * u) @ p["we_o"][e]
    out = (ye * gate_vals.to(ye.dtype)[..., None]).sum(1)
    return out.reshape(B, S, width)


def _held_picks(cfg: ModelConfig, expert_ids: torch.Tensor, e0: int,
                n: int):
    """(local expert, token rows, pick slots) for each expert ``e0 ..
    e0 + n - 1`` that a (T, K) pick reaches.  Fake ids (a traced plan)
    have no values to read: there the rank's share of the picks, T·K·n/E,
    falls on as many of its experts as it can, in equal groups."""
    if is_fake(expert_ids):
        T, K = expert_ids.shape
        picks = -(-T * K * n // cfg.moe.n_experts)
        touched = min(n, picks)
        slot = torch.arange(-(-picks // touched), device=expert_ids.device)
        for e in range(touched):
            yield e, slot % T, slot % K
        return
    for e in torch.unique(expert_ids).tolist():
        if e0 <= e < e0 + n:
            t, k = (expert_ids == e).nonzero(as_tuple=True)
            yield e - e0, t, k
