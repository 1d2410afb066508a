"""Shared neural layers: norms, RoPE / M-RoPE, GQA + MLA attention, MLPs.

Counterpart of ``repro.models.layers``.  Functional, as there: ``init_*``
builds a dict of tensors from an explicit ``torch.Generator`` (on the
generator's device), ``apply_*`` consumes one.  Attention takes a
query-block pass in plain PyTorch that never holds more than (block_q, Skv)
scores per head, or, on the calls the JAX package routes to its Pallas
kernel, the hand-written flash kernel (:func:`set_attention_impl`).  MLA
passes an explicit scale, so it always takes the plain pass, as in the JAX
package; its absorbed decode attends in the latent space, in f32.

Under autograd the plain pass recomputes each query block's scores in the
backward pass (:func:`checkpointed`), as the JAX package's
``jax.checkpoint`` over its block does, and the kernel branch raises: the
flash kernel has no backward, as JAX's Pallas attention has no VJP.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.distribution.constraints import (
    axes_of,
    batch_entry,
    constrain,
    current_mesh,
    is_dtensor,
    local_call,
    model_axis_size,
    model_entry,
    reduce_over,
    shard_index,
    spec_now,
    whole,
    whole_last,
    write_slots,
)
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels._grad import needs_grad
from repro_torch.models.config import ModelConfig

Params = Dict[str, Any]


# ---------------------------------------------------------------------------
# init helpers
# ---------------------------------------------------------------------------

def checkpointed(fn, *args, on: bool = True, **kwargs):
    """``fn(*args, **kwargs)`` keeping only its inputs for the backward
    pass, which runs it again (``jax.checkpoint`` with nothing saveable);
    with ``on`` false, ``fn`` called as it is.  The model draws no random
    numbers, so no generator state is kept."""
    if not on:
        return fn(*args, **kwargs)
    return checkpoint(fn, *args, use_reentrant=False,
                      preserve_rng_state=False, **kwargs)


def dense_init(gen: torch.Generator, d_in: int, d_out: int,
               dtype=torch.float32, scale: Optional[float] = None):
    """(d_in, d_out) weights drawn N(0, 1) from ``gen`` on its device, times
    ``scale`` (default 1/sqrt(d_in)), in ``dtype``."""
    scale = scale if scale is not None else 1.0 / math.sqrt(d_in)
    w = torch.randn((d_in, d_out), generator=gen, device=gen.device,
                    dtype=torch.float32)
    return (w * scale).to(dtype)


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

def rmsnorm(x: torch.Tensor, scale: torch.Tensor,
            eps: float = 1e-5) -> torch.Tensor:
    if is_dtensor(x):   # a width split over ranks is gathered to normalise
        x = whole_last(x)
    x32 = x.float()
    var = (x32 * x32).mean(dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * whole(scale).float()).to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE / M-RoPE
# ---------------------------------------------------------------------------

def rope_freqs(hd_rot: int, theta: float, device=None) -> torch.Tensor:
    """Inverse frequencies for a rotary block of ``hd_rot`` dims."""
    dims = torch.arange(0, hd_rot, 2, dtype=torch.float32, device=device)
    return 1.0 / (theta ** (dims / hd_rot))


def rope_apply(x: torch.Tensor, positions: torch.Tensor, theta: float,
               mrope_sections: Optional[Tuple[int, int, int]] = None
               ) -> torch.Tensor:
    """Rotate ``x`` (..., S, H, hd) by position-dependent angles.

    positions: (B, S) for standard RoPE, (3, B, S) for M-RoPE where the three
    planes are (temporal, height, width) ids and the frequency dims are split
    into ``mrope_sections`` groups (Qwen2-VL §2.1).
    """
    hd = x.shape[-1]
    inv = rope_freqs(hd, theta, x.device)               # (hd/2,)
    pos = positions.float()
    if mrope_sections is None:
        ang = pos[..., None] * inv                      # (B, S, hd/2)
    else:
        if positions.dim() != 3:
            raise ValueError("M-RoPE needs (3, B, S) position ids")
        if sum(mrope_sections) != hd // 2:
            raise ValueError(f"M-RoPE sections {mrope_sections} do not "
                             f"cover hd/2 = {hd // 2}")
        ang_full = pos[..., None] * inv                 # (3, B, S, hd/2)
        parts, start = [], 0
        for i, s in enumerate(mrope_sections):
            parts.append(ang_full[i, :, :, start:start + s])
            start += s
        ang = torch.cat(parts, dim=-1)                  # (B, S, hd/2)
    cos = torch.cos(ang)[:, :, None, :]                 # (B, S, 1, hd/2)
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# attention core: query-block pass or the flash kernel
# ---------------------------------------------------------------------------

_ATTN_IMPL = "plain"   # "plain" (query-block pass) | "kernel" (flash kernel)


def set_attention_impl(impl: str) -> None:
    """Select the attention backend for cache-less (scoring, encoder,
    cross-attention) calls: ``"plain"`` (the default) or ``"kernel"``, the
    counterparts of the JAX package's ``"xla"`` (its default) and
    ``"pallas"``.

    ``"kernel"`` routes through :func:`repro_torch.kernels.attention`: the
    CUDA flash kernel for tensors on the card, its plain version on the
    CPU.  Calls with a cache (cache writes, ragged validity, a query
    offset), an explicit scale or hd != hdv always take the plain pass, as
    in the JAX package.
    """
    global _ATTN_IMPL
    if impl not in ("plain", "kernel"):
        raise ValueError(f"attention impl must be 'plain' or 'kernel', "
                         f"not {impl!r}")
    _ATTN_IMPL = impl


def _mesh_core(q, k, v, **kw) -> torch.Tensor:
    """:func:`attention_core` on a mesh: each rank attends with its batch
    rows and, where the model axis divides the query heads, its heads
    against the key and value heads they read (every key and value head
    where the model axis divides those too; else the keys and values are
    made whole and each rank keeps its groups' heads, as GSPMD lays out a
    grouped query whose key heads the axis does not divide).  A head
    count the model axis does not divide is split by
    :func:`_blocked_attention` before it gets here, or (a decode step)
    attends with every head.  Keys and values stay where the cache rule
    put them when their sequence is split (the batch-1 rule), or when
    their head width is split and the scores are narrower than the keys
    and values (a decode step): each rank then attends over its own slots
    and width (:func:`_split_attention`).  Else the head width is made
    whole."""
    B, Sq, H, hd = q.shape
    KV, hdv = k.shape[2], v.shape[3]
    b = batch_entry(B)
    h = model_entry(H) and model_entry(KV)
    ks, vs = spec_now(k), spec_now(v)
    seq = ks[1] if ks[1] == vs[1] else None
    wide = (h is None and ks[3] == vs[3] == "model"
            and H * Sq * 4 < KV * (hd + hdv) * k.element_size())
    if (seq or wide) and Sq <= kw["block_q"] and not needs_grad(q, k, v):
        w = "model" if wide else None
        qs, kvs = (b, None, h, w), (b, seq, h, w)
        scale = kw["scale"] if kw["scale"] is not None else 1 / math.sqrt(hd)
        (o,) = local_call(
            lambda q, k, v: (_split_attention(q, k, v, seq, w, **dict(
                kw, scale=scale)),), (q, k, v), (qs, kvs, kvs), [(qs, ())])
        return o
    hq = H // model_axis_size() if model_entry(H) else 0
    if h is None and hq and (hq % (H // KV) == 0 or (H // KV) % hq == 0):
        # the query heads split, each rank's key and value heads taken
        # from them made whole
        qs, kvs = (b, None, "model", None), (b, None, None, None)

        def own(q, k, v):
            kv0 = current_mesh().get_local_rank("model") * hq // (H // KV)
            n = max(1, hq // (H // KV))
            return (attention_core(q, k[:, :, kv0:kv0 + n],
                                   v[:, :, kv0:kv0 + n], **kw),)

        (o,) = local_call(own, (q, k, v), (qs, kvs, kvs), [(qs, ())],
                          grad_partial=[(), ("model",), ("model",)])
        return o
    spec = (b, None, h, None)
    (o,) = local_call(lambda q, k, v: (attention_core(q, k, v, **kw),),
                      (q, k, v), (spec, spec, spec), [(spec, ())])
    return o


def head_blocks(H: int, KV: int, m: int, Sq: int,
                block_q: int) -> Optional[Tuple[int, int]]:
    """How a model axis of ``m`` ranks (0: none) splits attention over
    ``H`` query heads it does not divide, ``KV`` key heads and ``Sq``
    query rows: ``(blocks, r)``, the query heads grouped by key head in
    ``blocks`` blocks as GSPMD splits them (the key heads over gcd(KV, m)
    ranks; when that takes every key head, each head's group over the gcd
    of its size and the ranks left), each block's rows over the ``r = m /
    blocks`` ranks that GSPMD leaves computing the same block.  Model rank
    ``i`` takes block ``i // r`` at part ``i % r`` of the rows; only part
    0's rows start at position 0, which the flash kernel needs.  None
    where ``m`` divides ``H`` (or is 0), or where the rows do not split
    into ``r`` parts the query-block pass takes (a decode step)."""
    if not m or H % m == 0:
        return None
    G = H // KV
    f_kv = math.gcd(KV, m)
    f_g = math.gcd(G, m // f_kv) if f_kv == KV else 1
    blocks = f_kv * f_g
    r = m // blocks
    rows = Sq // r
    if Sq < 2 or Sq % r or (rows > block_q and rows % block_q):
        return None
    return blocks, r


def _blocked_attention(p: Params, cfg: ModelConfig, x: torch.Tensor,
                       positions: torch.Tensor, k: torch.Tensor,
                       v: torch.Tensor, blocks: int, r: int, *,
                       causal: bool, q_offset: int = 0,
                       window: Optional[int] = None,
                       kv_valid_len: Optional[int] = None,
                       block_q: int = 1024) -> torch.Tensor:
    """Attention and its output projection on a mesh whose model axis does
    not divide the ``H`` query heads (:func:`head_blocks`): model rank
    ``i`` projects, rotates and attends with the query heads of block
    ``i // r`` at its ``1/r`` of the rows (``i % r``), against the key and
    value heads they read (made whole), and projects its output with its
    heads' rows of ``wo``; the ranks' outputs are summed (a partial sum
    over the model axis, reduced here).  No rank computes another's heads
    and rows, and no query is gathered: the projections' weights are made
    whole instead.  Rows after the first part attend with an offset, so
    the flash kernel takes only the first part's (as JAX's kernel takes
    no offset)."""
    B, Sq, _ = x.shape
    H, KV, hd = cfg.n_heads, cfg.n_kv, cfg.hd
    G, hq, rows = H // KV, H // blocks, Sq // r
    b = batch_entry(B)
    ws = [whole(p["wq"]), whole(p["wo"])]
    if "bq" in p:
        ws.append(whole(p["bq"]))
    pos_spec = None
    if is_dtensor(positions):
        pos_spec = (b, None) if positions.ndim == 2 else (None, b, None)

    def local(x, k, v, pos, wq, wo, *bq):
        i = current_mesh().get_local_rank("model")
        blk, part = divmod(i, r)
        r0, cols = part * rows, slice(blk * hq * hd, (blk + 1) * hq * hd)
        n = x.shape[0]
        if pos_spec is None:      # a plain tensor of every batch row
            pos = pos.narrow(-2, shard_index(b) * n, n)
        # contiguous rows: one (rows, d) × (d, hq·hd) product, not a
        # batched one over a slice the weight is broadcast to
        q = project_query(x[:, r0:r0 + rows].contiguous(), wq[:, cols],
                          bq[0][cols] if bq else None,
                          pos[..., r0:r0 + rows], cfg, hq)
        kv0, nkv = blk * hq // G, max(1, hq // G)
        o = attention_core(q, k[:, :, kv0:kv0 + nkv], v[:, :, kv0:kv0 + nkv],
                           causal=causal, q_offset=q_offset + r0,
                           window=window, kv_valid_len=kv_valid_len,
                           block_q=block_q)
        out = project_out(o, wo[cols])
        return (F.pad(out, (0, 0, r0, Sq - r0 - rows)),)

    kvs = (b, None, None, None)
    axes = axes_of(b) + ("model",)
    specs = [(b, None, None), kvs, kvs, pos_spec] + [(None,) * w.ndim
                                                     for w in ws]
    (out,) = local_call(local, (x, k, v, positions, *ws), specs,
                        [((b, None, None), ("model",))],
                        grad_partial=[("model",), ("model",), ("model",),
                                      ()] + [axes] * len(ws))
    return constrain(out, b, None, None)


def _split_attention(q, k, v, seq, width, *, causal, q_offset, window,
                     kv_valid_len, block_q, scale) -> torch.Tensor:
    """One rank's part of :func:`attention_core` over keys and values whose
    sequence is split over the axes ``seq`` and / or whose head width is
    split over ``width`` (q's width split alike).  The scores' partial sums
    over the width are reduced, then the softmax's max and sum over the
    sequence's ranks, and the output's partial sums over them: the keys and
    values never move."""
    B, Sq, H, hd = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    s = torch.einsum("bqkgh,bskh->bkgqs",
                     q.reshape(B, Sq, KV, H // KV, hd).float() * scale,
                     k.float())
    s = reduce_over(s, "sum", width)
    kv_idx = shard_index(seq) * Skv + torch.arange(Skv, device=q.device)
    rows = torch.arange(Sq, device=q.device) + q_offset
    mask = torch.ones((Sq, Skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kv_idx[None, :] <= rows[:, None]
    if window is not None:
        mask &= kv_idx[None, :] > rows[:, None] - window
    if kv_valid_len is not None:
        mask &= kv_idx[None, :] < kv_valid_len
    s = s.masked_fill(~mask, -math.inf)
    top = reduce_over(s.amax(dim=-1, keepdim=True), "max", seq)
    p = torch.exp(s - top)
    p = torch.where(torch.isnan(p), 0.0, p)            # fully-masked rows
    p = p / reduce_over(p.sum(dim=-1, keepdim=True), "sum", seq)
    p = torch.where(torch.isnan(p), 0.0, p)
    o = reduce_over(torch.einsum("bkgqs,bskh->bqkgh", p, v.float()), "sum",
                    seq)
    return o.to(v.dtype).reshape(B, Sq, H, -1)


def merge_heads(o: torch.Tensor) -> torch.Tensor:
    """(B, S, H, hd) as (B, S, H·hd); on a mesh the heads stay split where
    the model axis divides them, the head width whole."""
    B, S, H, hd = o.shape
    if is_dtensor(o):
        o = constrain(o, batch_entry(B), None, model_entry(H), None)
    return o.reshape(B, S, H * hd)


def attention_core(
    q: torch.Tensor,           # (B, Sq, H, hd)
    k: torch.Tensor,           # (B, Skv, KV, hd)
    v: torch.Tensor,           # (B, Skv, KV, hdv)
    *,
    causal: bool,
    q_offset: int = 0,
    window: Optional[int] = None,
    kv_valid_len: Optional[int] = None,
    block_q: int = 1024,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Exact attention, O(block_q · Skv) live scores per head.

    ``q_offset``: absolute position of q[0] (decode: the cache index).
    ``window``: sliding-window width (None = full).
    ``kv_valid_len``: mask out cache slots >= this length (decode).
    """
    if is_dtensor(q):
        return _mesh_core(q, k, v, causal=causal, q_offset=q_offset,
                          window=window, kv_valid_len=kv_valid_len,
                          block_q=block_q, scale=scale)
    B, Sq, H, hd = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    G = H // KV
    grad = needs_grad(q, k, v)
    if (_ATTN_IMPL == "kernel" and kv_valid_len is None and scale is None
            and q_offset == 0 and q.shape[-1] == v.shape[-1]):
        if grad:
            raise RuntimeError(
                "attention: the flash kernel has no backward (as the JAX "
                "package's Pallas attention has no VJP); train under "
                "set_attention_impl('plain')")
        return _fa.attention(q, k, v, causal=causal, window=window)
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    qg = q.reshape(B, Sq, KV, G, hd)
    kv_idx = torch.arange(Skv, device=q.device)
    k32 = k.float()

    def one_block(qb, row0):
        bq = qb.shape[1]
        s = torch.einsum("bqkgh,bskh->bkgqs", qb.float() * scale, k32)
        rows = row0 + torch.arange(bq, device=q.device) + q_offset
        mask = torch.ones((bq, Skv), dtype=torch.bool, device=q.device)
        if causal:
            mask &= kv_idx[None, :] <= rows[:, None]
        if window is not None:
            mask &= kv_idx[None, :] > rows[:, None] - window
        if kv_valid_len is not None:
            mask &= kv_idx[None, :] < kv_valid_len
        s = s.masked_fill(~mask, -math.inf)
        p = torch.softmax(s, dim=-1)
        p = torch.where(torch.isnan(p), 0.0, p)          # fully-masked rows
        o = torch.einsum("bkgqs,bskh->bqkgh", p.to(v.dtype), v)
        return o.reshape(B, bq, H, -1)

    # under autograd a block's (bq, Skv) scores and probabilities are
    # recomputed in the backward pass, never kept across blocks
    if Sq <= block_q:
        return checkpointed(one_block, qg, 0, on=grad)
    if Sq % block_q:
        raise ValueError(f"Sq={Sq} is not a multiple of block_q={block_q}")
    return torch.cat([checkpointed(one_block, qg[:, r:r + block_q], r,
                                   on=grad)
                      for r in range(0, Sq, block_q)], dim=1)


# ---------------------------------------------------------------------------
# GQA attention layer
# ---------------------------------------------------------------------------

def split_heads(x: torch.Tensor, n: int, hd: int) -> torch.Tensor:
    """(B, S, n·hd) as (B, S, n, hd).  On a mesh whose model axis does not
    divide the ``n`` heads the width is gathered first: the key and value
    heads of grouped attention, which each rank reads whole
    (:func:`_mesh_core`, :func:`_blocked_attention`); a query that no
    model rank splits by heads (a decode step)."""
    B, S = x.shape[:2]
    m = model_axis_size()
    if m and n % m and is_dtensor(x):
        x = constrain(x, batch_entry(B), None, None)
    return x.reshape(B, S, n, hd)


def head_weight(w: torch.Tensor, n: int, hd: int) -> torch.Tensor:
    """A (d_in, n·hd) weight as (d_in, n, hd), gathered first where the
    model axis does not divide the ``n`` heads (as :func:`split_heads`)."""
    m = model_axis_size()
    if m and n % m and is_dtensor(w):
        w = whole(w)
    return w.reshape(w.shape[0], n, hd)


def rotate(x: torch.Tensor, positions: torch.Tensor,
           cfg: ModelConfig) -> torch.Tensor:
    """:func:`rope_apply` with ``cfg``'s base and M-RoPE sections."""
    sec = cfg.mrope_sections if cfg.rope == "mrope" else None
    return rope_apply(x, positions, cfg.rope_theta, sec)


def project_query(x: torch.Tensor, wq: torch.Tensor,
                  bq: Optional[torch.Tensor], positions: Optional[torch.Tensor],
                  cfg: ModelConfig, n: int) -> torch.Tensor:
    """The ``n`` query heads of ``x`` (B, S, d): ``x @ wq`` plus the bias
    ``bq`` (if any), rotated at ``positions`` (None: not rotated, as the
    queries against an encoder's or given keys).  :func:`apply_attention`
    passes a layer's weights, :func:`_blocked_attention` a rank's heads'
    columns of them and its rows of ``x``."""
    q = x @ wq
    if bq is not None:
        q = q + bq.to(q.dtype)
    q = split_heads(q, n, cfg.hd)
    if positions is not None and cfg.rope != "none":
        q = rotate(q, positions, cfg)
    return q


def project_out(o: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    """Attention's output (B, S, H, hd) through ``wo`` (H·hd, d)."""
    return merge_heads(o) @ wo


def init_attention(gen: torch.Generator, cfg: ModelConfig,
                   dtype=torch.float32) -> Params:
    d, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.hd
    p = {
        "wq": dense_init(gen, d, H * hd, dtype),
        "wk": dense_init(gen, d, KV * hd, dtype),
        "wv": dense_init(gen, d, KV * hd, dtype),
        "wo": dense_init(gen, H * hd, d, dtype),
    }
    if cfg.qkv_bias:
        for name, width in (("bq", H * hd), ("bk", KV * hd), ("bv", KV * hd)):
            p[name] = torch.zeros((width,), dtype=dtype, device=gen.device)
    return p


def apply_attention(
    p: Params,
    cfg: ModelConfig,
    x: torch.Tensor,                     # (B, S, d)
    positions: torch.Tensor,             # (B, S) or (3, B, S)
    *,
    causal: bool = True,
    window: Optional[int] = None,
    cache: Optional[Params] = None,      # {"k": (B,Sc,KV,hd), "v": ...} decode
    cache_index: Optional[int] = None,
    cross_y: Optional[torch.Tensor] = None,          # encoder output (prefill)
    kv_override: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    block_q: int = 1024,
) -> Tuple[torch.Tensor, Optional[Params]]:
    """GQA attention.  With a ``cache`` the new keys and values are written
    into it in place (slice assignment at ``cache_index``, a ring buffer
    under ``window``) and the returned cache is the same dict; the JAX
    package returns new arrays instead."""
    B, S, d = x.shape
    H, KV, hd = cfg.n_heads, cfg.n_kv, cfg.hd
    blocked = (head_blocks(H, KV, model_axis_size(), S, block_q)
               if is_dtensor(x) and cross_y is None and kv_override is None
               else None)
    # queries against the encoder's or given keys are not rotated; on a
    # blocked mesh each model rank projects its own heads
    rot = positions if cross_y is None and kv_override is None else None
    q = None if blocked else project_query(x, p["wq"], p.get("bq"), rot,
                                           cfg, H)

    if cross_y is not None:
        # cross-attention: keys/values from the encoder sequence, no RoPE
        k = split_heads(cross_y @ p["wk"], KV, hd)
        v = split_heads(cross_y @ p["wv"], KV, hd)
        out = attention_core(q, k, v, causal=False, block_q=block_q)
        return project_out(out, p["wo"]), {"k": k, "v": v}  # static cache
    if kv_override is not None:
        k, v = kv_override
        out = attention_core(q, k, v, causal=False, block_q=block_q)
        return project_out(out, p["wo"]), None
    # self-attention path
    k = x @ p["wk"]
    v = x @ p["wv"]
    if "bk" in p:
        k = k + p["bk"].to(k.dtype)
        v = v + p["bv"].to(v.dtype)
    k = split_heads(k, KV, hd)
    v = split_heads(v, KV, hd)
    if cfg.rope != "none":
        k = rotate(k, positions, cfg)

    new_cache = None
    if cache is not None:
        # decode: write new k/v at cache_index, attend over the cache
        ck, cv = cache["k"], cache["v"]
        Sc = ck.shape[1]
        slot = cache_index % Sc if window is not None else cache_index
        slot = min(max(slot, 0), Sc - S)   # clamped as dynamic_update_slice
        write_slots(ck, slot, k)
        write_slots(cv, slot, v)
        new_cache = cache
        kv_valid = min(cache_index + S, Sc)
        # Ring buffer: it holds exactly the last `window` positions, so all
        # filled slots are attendable and absolute-position masks don't apply.
        causal_here = False if window is not None else causal
        kw = dict(causal=causal_here, q_offset=cache_index, window=None,
                  kv_valid_len=kv_valid, block_q=block_q)
        k, v = ck, cv
    else:
        kw = dict(causal=causal, window=window, block_q=block_q)
    if blocked is not None:
        return _blocked_attention(p, cfg, x, positions, k, v, *blocked,
                                  **kw), new_cache
    return project_out(attention_core(q, k, v, **kw), p["wo"]), new_cache


# ---------------------------------------------------------------------------
# MLA (multi-head latent attention, DeepSeek-V2)
# ---------------------------------------------------------------------------

def init_mla(gen: torch.Generator, cfg: ModelConfig,
             dtype=torch.float32) -> Params:
    m = cfg.mla
    d, H = cfg.d_model, cfg.n_heads
    qk = m.qk_nope_dim + m.qk_rope_dim
    p: Params = {}
    if m.q_lora:
        p["wdq"] = dense_init(gen, d, m.q_lora, dtype)
        p["q_norm"] = torch.ones((m.q_lora,), dtype=dtype, device=gen.device)
        p["wuq"] = dense_init(gen, m.q_lora, H * qk, dtype)
    else:
        p["wq"] = dense_init(gen, d, H * qk, dtype)
    p["wdkv"] = dense_init(gen, d, m.kv_lora, dtype)
    p["kv_norm"] = torch.ones((m.kv_lora,), dtype=dtype, device=gen.device)
    # separate K-up / V-up weights, as the JAX package keeps them
    p["wuk"] = dense_init(gen, m.kv_lora, H * m.qk_nope_dim, dtype)
    p["wuv"] = dense_init(gen, m.kv_lora, H * m.v_head_dim, dtype)
    p["wkr"] = dense_init(gen, d, m.qk_rope_dim, dtype)
    p["wo"] = dense_init(gen, H * m.v_head_dim, d, dtype)
    return p


def _mla_q(p: Params, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    m = cfg.mla
    qk = m.qk_nope_dim + m.qk_rope_dim
    if "wdq" in p:
        q = rmsnorm(x @ p["wdq"], p["q_norm"], cfg.norm_eps) @ p["wuq"]
    else:
        q = x @ p["wq"]
    return split_heads(q, cfg.n_heads, qk)


def apply_mla(
    p: Params,
    cfg: ModelConfig,
    x: torch.Tensor,                     # (B, S, d)
    positions: torch.Tensor,             # (B, S)
    *,
    window: Optional[int] = None,
    cache: Optional[Params] = None,      # {"ckv": (B,Sc,kv_lora), "krope": (B,Sc,rope)}
    cache_index: Optional[int] = None,
    absorb: bool = False,
    block_q: int = 1024,
) -> Tuple[torch.Tensor, Optional[Params]]:
    """MLA.  With a ``cache`` the new latents and rope keys are written into
    it in place (at ``cache_index``, a ring buffer under ``window``) and
    the returned cache is the same dict.  ``absorb`` attends in the
    latent space (score = (q_nope · W_ukᵀ) · ckvᵀ, W_uv folded into the
    output), in f32 as the JAX package computes it."""
    m = cfg.mla
    B, S, d = x.shape
    H = cfg.n_heads
    nope, rope_d, hdv = m.qk_nope_dim, m.qk_rope_dim, m.v_head_dim
    scale = 1.0 / math.sqrt(nope + rope_d)

    q = _mla_q(p, cfg, x)
    q_nope, q_rope = q[..., :nope], q[..., nope:]
    q_rope = rope_apply(q_rope, positions, cfg.rope_theta)

    ckv = rmsnorm(x @ p["wdkv"], p["kv_norm"], cfg.norm_eps)  # (B, S, kv_lora)
    krope = rope_apply((x @ p["wkr"]).reshape(B, S, 1, rope_d), positions,
                       cfg.rope_theta).reshape(B, S, rope_d)

    new_cache = None
    q_offset = 0
    kv_valid = None
    causal = True
    if cache is not None:
        cc, cr = cache["ckv"], cache["krope"]
        Sc = cc.shape[1]
        if window is not None:
            # ring buffer: every filled slot is attendable
            slot, causal = cache_index % Sc, False
        else:
            slot = cache_index
        slot = min(max(slot, 0), Sc - S)   # clamped as dynamic_update_slice
        write_slots(cc, slot, ckv)
        write_slots(cr, slot, krope)
        ckv, krope = cc, cr
        new_cache = cache
        q_offset = cache_index
        kv_valid = min(cache_index + S, Sc)

    Skv = ckv.shape[1]
    wuk = head_weight(p["wuk"], H, nope)
    wuv = head_weight(p["wuv"], H, hdv)

    if absorb:
        # ---- absorbed decode: attention in the kv_lora-dim latent space --
        q_lat = torch.einsum("bqhn,lhn->bqhl", q_nope.float(), wuk.float())
        ckv32 = ckv.float()
        s = torch.einsum("bqhl,bsl->bhqs", q_lat * scale, ckv32)
        s = s + torch.einsum("bqhr,bsr->bhqs", q_rope.float() * scale,
                             krope.float())
        kv_idx = torch.arange(Skv, device=x.device)
        rows = q_offset + torch.arange(S, device=x.device)
        mask = torch.ones((S, Skv), dtype=torch.bool, device=x.device)
        if causal:
            mask &= kv_idx[None, :] <= rows[:, None]
        if kv_valid is not None:
            mask &= kv_idx[None, :] < kv_valid
        s = s.masked_fill(~mask, -math.inf)
        pw = torch.softmax(s, dim=-1)
        pw = torch.where(torch.isnan(pw), 0.0, pw)
        o_lat = torch.einsum("bhqs,bsl->bqhl", pw, ckv32)       # (B,S,H,kvl)
        out = torch.einsum("bqhl,lhv->bqhv", o_lat, wuv.float())
        out = merge_heads(out).to(x.dtype) @ p["wo"]
        return out, new_cache

    # ---- faithful reconstruct path ----------------------------------------
    if is_dtensor(ckv):
        # the latent (kv_lora wide) made whole on the model ranks, not the
        # products (H·nope and H·hdv wide): each rank reconstructs its own
        # heads' keys and values where the latents lie
        ckv, krope = whole_last(ckv), whole_last(krope)
    k_nope = torch.einsum("bsl,lhe->bshe", ckv, wuk.to(ckv.dtype))
    v = torch.einsum("bsl,lhe->bshe", ckv, wuv.to(ckv.dtype))
    # K: the reconstructed k_nope joined to krope shared by every head; its
    # width nope + rope differs from V's hdv
    k = _join_rope(k_nope, krope)
    qfull = torch.cat([q_nope, q_rope], dim=-1)
    out = attention_core(qfull, k, v, causal=causal, q_offset=q_offset,
                         kv_valid_len=kv_valid, block_q=block_q, scale=scale)
    out = merge_heads(out) @ p["wo"]
    return out, new_cache


def _join_rope(k_nope: torch.Tensor, krope: torch.Tensor) -> torch.Tensor:
    """(B, S, H, nope) keys joined to the (B, S, rope) rope keys that every
    head shares.  On a mesh each rank joins its own heads and rows (the
    rope keys' gradient a partial sum over the heads' ranks)."""
    def join(kn, kr):
        B, S, H, _ = kn.shape
        return (torch.cat([kn, kr[:, :, None, :].expand(B, S, H, -1)
                           .to(kn.dtype)], dim=-1),)

    if not is_dtensor(k_nope):
        return join(k_nope, krope)[0]
    rows = spec_now(krope)
    spec = (rows[0], rows[1], model_entry(k_nope.shape[2]), None)
    (k,) = local_call(join, (k_nope, krope), (spec, rows[:2] + (None,)),
                      [(spec, ())], grad_partial=[(), axes_of(spec[2])])
    return k


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------

def init_mlp(gen: torch.Generator, d: int, d_ff: int, kind: str = "mlp",
             dtype=torch.float32) -> Params:
    if kind == "mlp":
        # SwiGLU with separate gate/up weights, as the JAX package keeps them
        return {"wgate": dense_init(gen, d, d_ff, dtype),
                "wup": dense_init(gen, d, d_ff, dtype),
                "wo": dense_init(gen, d_ff, d, dtype)}
    return {"wi": dense_init(gen, d, d_ff, dtype),
            "wo": dense_init(gen, d_ff, d, dtype)}


def apply_mlp(p: Params, x: torch.Tensor, kind: str = "mlp") -> torch.Tensor:
    if kind == "mlp":
        return (F.silu(x @ p["wgate"]) * (x @ p["wup"])) @ p["wo"]
    # jax.nn.gelu's default is the tanh approximation
    return F.gelu(x @ p["wi"], approximate="tanh") @ p["wo"]
