"""Top-level language model: embedding → layer stack → norm → head.

Counterpart of ``repro.models.model`` for every family of the JAX package:
dense, MoE (grok-1; DeepSeek-V2 with MLA), SSM (RWKV-6), hybrid (Jamba:
Mamba and attention, dense and MoE FFNs), audio (encoder-decoder) and VLM:

* ``init_lm``            — an :class:`LM` with seeded random weights
* ``from_reference``     — an :class:`LM` holding the JAX package's weights
  (``unstack_reference`` for any tree in their layout, the optimiser's
  moments too); ``to_reference`` is its inverse
* ``forward_train``      — tokens → loss (plus the MoE aux loss) and
  accuracy (chunked vocab cross-entropy), differentiable
* ``prefill``            — tokens → (last-position logits, filled caches)
* ``decode_step``        — one token with caches (serve_step's core);
  ``RunFlags(mla_absorb=True)`` takes MLA's latent-space decode
* ``make_caches``        — per-layer decode state for (cfg, batch,
  cache_len): attention keys and values, MLA's latents, the SSM mixers'
  states

VLM (qwen2-vl): precomputed patch embeddings are spliced over the first
``n_vis`` token positions and M-RoPE takes (3, B, S) position ids.
Audio (whisper): precomputed frame embeddings feed a bidirectional encoder;
the decoder cross-attends (the frontend is stubbed, as in the JAX package).

Training: an :class:`LM`'s parameters require no gradient until
``lm.requires_grad_()`` (the trainer, ``repro_torch.train``, turns it on),
so scoring and serving build no autograd graph.  Under autograd the loss
recomputes each chunk's logits in the backward pass and the plain
attention each query block's scores, as the JAX package's ``jax.checkpoint``
with nothing saveable does; ``RunFlags(remat=True)`` also recomputes each
layer (decoder and encoder).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch._device import resolve
from repro_torch.distribution.constraints import (
    axes_of,
    batch_entry,
    constrain_batch_dim,
    gather_fsdp,
    is_dtensor,
    local_call,
    sum_all,
)
from repro_torch.kernels._grad import needs_grad
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import checkpointed, dense_init, rmsnorm
from repro_torch.models.transformer import (
    apply_stack,
    check_ported,
    init_stack,
    stack_cache_init,
)

Params = Dict[str, Any]

ENC_PERIOD = (("attn", "gelu_mlp"),)  # whisper encoder layers


@dataclasses.dataclass(frozen=True)
class RunFlags:
    """Execution knobs (not architecture): set by launcher / perf configs."""
    window: Optional[int] = None       # sliding-window attention (long_500k)
    mla_absorb: bool = False           # MLA latent-space decode
    block_q: int = 1024                # q-block size of the plain attention
    remat: bool = False                # activation checkpointing over periods
    loss_chunk: int = 512              # seq chunk for vocab cross-entropy


class ParamTree(nn.Module):
    """A nested dict (and list) of tensors held as parameters, each named
    by its path (``blocks.3.mixer.wq``); they require no gradient until
    ``requires_grad_()``."""

    def __init__(self, tree: Params):
        super().__init__()
        for name, leaf in tree.items():
            if isinstance(leaf, dict):
                self.add_module(name, ParamTree(leaf))
            elif isinstance(leaf, list):
                self.add_module(name, nn.ModuleList(ParamTree(t) for t in leaf))
            else:
                self.register_parameter(
                    name, nn.Parameter(leaf, requires_grad=False))

    def tree(self) -> Params:
        """The parameters as the nested dicts and lists they came from."""
        out: Params = {name: t for name, t in self._parameters.items()}
        for name, mod in self._modules.items():
            out[name] = ([m.tree() for m in mod]
                         if isinstance(mod, nn.ModuleList) else mod.tree())
        return out


class LM(ParamTree):
    """A language model's weights: ``embed``, ``final_norm``, ``blocks`` (one
    entry per decoder layer), ``lm_head`` unless tied, and for
    encoder-decoder models ``enc_blocks`` and ``enc_norm``.  The functions of
    this module take it (or :func:`cast_params` of it) as ``p``."""

    def __init__(self, cfg: ModelConfig, tree: Params):
        super().__init__(tree)
        self.cfg = cfg


def map_tree(fn, tree):
    """``fn`` over the leaves of nested dicts and lists, nested as given."""
    if isinstance(tree, dict):
        return {k: map_tree(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [map_tree(fn, v) for v in tree]
    return fn(tree)


def cast_params(p: Union[ParamTree, Params], dtype, device=None) -> Params:
    """Mixed precision: the weights as nested dicts of tensors in ``dtype``
    (float leaves only), on ``device`` if given.  A leaf already in that
    dtype and on that device is returned as it is, not copied."""
    if isinstance(p, ParamTree):
        p = p.tree()
    floats = (torch.float32, torch.bfloat16)
    return map_tree(lambda a: a.to(device=device,
                               dtype=dtype if a.dtype in floats else a.dtype),
                p)


def sinusoid_pos(S: int, d: int, dtype, device=None) -> torch.Tensor:
    pos = torch.arange(S, dtype=torch.float32, device=device)[:, None]
    dim = torch.arange(0, d, 2, dtype=torch.float32, device=device)[None, :]
    ang = pos / torch.pow(10000.0, dim / d)
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1).to(dtype)


def init_lm(cfg: ModelConfig, seed: int = 0, *, dtype=torch.float32,
            device="cuda") -> LM:
    """Random weights drawn from a ``torch.Generator`` seeded with ``seed``
    on ``device`` (the card unless ``device="cpu"``).  The draws are not the
    JAX package's; :func:`from_reference` carries those across."""
    check_ported(cfg)
    dev = resolve(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    d = cfg.d_model
    p: Params = {
        "embed": (torch.randn((cfg.vocab, d), generator=gen, device=dev)
                  * 0.02).to(dtype),
        "final_norm": torch.ones((d,), dtype=dtype, device=dev),
        "blocks": init_stack(gen, cfg, dtype, with_cross=cfg.enc_dec),
    }
    if not cfg.tie_embeddings:
        p["lm_head"] = dense_init(gen, d, cfg.vocab, dtype, scale=0.02)
    if cfg.enc_dec:
        p["enc_blocks"] = init_stack(gen, cfg, dtype, period=ENC_PERIOD,
                                     n_periods=cfg.n_enc_layers)
        p["enc_norm"] = torch.ones((d,), dtype=dtype, device=dev)
    return LM(cfg, p)


def _tensor(a, device) -> torch.Tensor:
    """A numpy leaf as a tensor; 2-byte leaves that are not integers (JAX's
    bf16, or the raw 2-byte records ``np.load`` gives back for them) as
    bf16."""
    a = np.asarray(a)
    if a.dtype.itemsize == 2 and a.dtype.kind not in "iuf":
        return torch.from_numpy(a.view(np.int16).copy()).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a)).to(device)


def _numpy(t: torch.Tensor) -> np.ndarray:
    """A tensor as numpy; bf16 as 2-byte records of its bits (``|V2``), the
    dtype numpy stores JAX's bf16 arrays under.  A DTensor is gathered
    whole first (``full_tensor``: every rank of its mesh must call)."""
    if is_dtensor(t):
        t = t.full_tensor()
    t = t.detach().to("cpu", copy=True)     # never a view of the weights
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view("V2")
    return t.numpy()


def _layout(cfg: ModelConfig):
    """(name, period, n_periods) of each stacked part of the JAX layout."""
    out = [("blocks", cfg.period, cfg.n_periods)]
    if cfg.enc_dec:
        out.append(("enc_blocks", ENC_PERIOD, cfg.n_enc_layers))
    return out


def unstack_reference(params: Params, cfg: ModelConfig, device) -> Params:
    """A tree in the JAX package's layout (nested dicts of numpy arrays,
    ``blocks`` / ``enc_blocks`` stacked) as the port's nested dicts of
    tensors on ``device``, one entry per layer: period ``i``'s position
    ``j`` at ``i * len(period) + j``."""
    p: Params = {name: _tensor(a, device) for name, a in params.items()
                 if not isinstance(a, dict)}
    for name, period, n_periods in _layout(cfg):
        stacked = params[name]
        p[name] = [map_tree(lambda a: _tensor(a[i], device),
                            stacked[f"pos{j}"])
                   for i in range(n_periods) for j in range(len(period))]
    return p


def to_reference(p: Union[ParamTree, Params], cfg: ModelConfig) -> Params:
    """The inverse of :func:`unstack_reference`: the port's weights (or a
    tree nested like them, such as AdamW's moments) as nested dicts of
    numpy arrays in the JAX package's layout, each ``pos{j}`` leaf stacked
    over the periods on a leading axis."""
    if isinstance(p, ParamTree):
        p = p.tree()
    out: Params = {name: _numpy(t) for name, t in p.items()
                   if not isinstance(t, list)}

    def stack(trees):
        if isinstance(trees[0], dict):
            return {k: stack([t[k] for t in trees]) for k in trees[0]}
        return np.stack([_numpy(t) for t in trees])

    for name, period, _ in _layout(cfg):
        P = len(period)
        out[name] = {f"pos{j}": stack(p[name][j::P]) for j in range(P)}
    return out


def from_reference(params: Params, cfg: ModelConfig, device="cuda") -> LM:
    """An :class:`LM` holding the JAX package's ``init_lm`` weights, given as
    nested dicts of numpy arrays (``jax.tree.map(np.asarray, params)``),
    every leaf carried across (the SSM mixers' ``mu_*``, ``w0``, ``wA``,
    ``wB``, ``u``, ``ln_scale``, ``conv_*``, ``x_proj``, ``dt_*``,
    ``A_log`` and ``D``, MLA's ``wdq``, ``q_norm``, ``wuq`` / ``wq``,
    ``wdkv``, ``kv_norm``, ``wuk``, ``wuv``, ``wkr`` and ``wo``, and the
    MoE FFN's ``router``, ``we_*`` and ``shared_*`` as the attention
    weights; a stacked ``(n_periods, E, d, d_expert)`` expert leaf gives
    each layer its ``(E, d, d_expert)`` slice).
    The JAX stacks (``blocks`` / ``enc_blocks``, ``pos{j}`` leaves with a
    leading ``n_periods`` axis) are unstacked into one entry per layer
    (:func:`unstack_reference`)."""
    check_ported(cfg)
    return LM(cfg, unstack_reference(params, cfg, resolve(device)))


def _on(batch: Dict[str, Any], device) -> Dict[str, torch.Tensor]:
    """The batch's arrays as tensors on ``device`` (DTensors, already
    placed on a mesh, as they are)."""
    return {k: v if is_dtensor(v) else torch.as_tensor(v, device=device)
            for k, v in batch.items()}


def _embed(p: Params, cfg: ModelConfig, tokens: torch.Tensor,
           vision_embed: Optional[torch.Tensor], dtype) -> torch.Tensor:
    """Token embeddings, the first ``nv`` positions replaced (not
    extended) by ``vision_embed`` (B, nv, d) when given.  ``F.embedding``
    rather than indexing: its backward sums a repeated token's rows in a
    fixed order (indexing's scatter-add does not, on the CPU)."""
    x = _lookup(p["embed"], tokens).to(dtype)
    if vision_embed is not None:
        nv = vision_embed.shape[1]
        x = torch.cat([vision_embed.to(dtype), x[:, nv:, :]], dim=1)
    return constrain_batch_dim(x)


def _lookup(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """``F.embedding(tokens, table)``.  On a mesh each rank looks its
    tokens up in the table's slice it holds: rows of a vocab-split table
    (the rows it lacks give 0, the output a partial sum over the model
    axis, reduced where the stream is pinned) or columns of a width-split
    one."""
    if not is_dtensor(table):
        return F.embedding(tokens.long(), table)
    from repro_torch.distribution.constraints import current_mesh
    from repro_torch.distribution.sharding import spec_of
    V, d = table.shape
    tspec = spec_of(table.placements, table.device_mesh, 2)
    rows = "model" if tspec[0] == "model" else None
    cols = "model" if tspec[1] == "model" else None
    b = batch_entry(tokens.shape[0])

    def local(table, tokens):
        if rows is None:
            return (F.embedding(tokens.long(), table),)
        v0 = current_mesh().get_local_rank("model") * table.shape[0]
        ids = tokens.long() - v0
        held = (ids >= 0) & (ids < table.shape[0])
        out = F.embedding(torch.where(held, ids, 0), table)
        return (out * held[..., None].to(out.dtype),)

    (x,) = local_call(local, (table, tokens), ((rows, cols), (b, None)),
                      [((b, None, cols), ("model",) if rows else ())],
                      grad_partial=[axes_of(b), ()])
    return x


def _head(p: Params, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    x = rmsnorm(x, p["final_norm"], cfg.norm_eps)
    w = p["embed"].T if cfg.tie_embeddings else p["lm_head"]
    return x @ w.to(x.dtype)


def _encode(p: Params, cfg: ModelConfig, audio_embed: torch.Tensor,
            flags: RunFlags) -> torch.Tensor:
    B, Se, d = audio_embed.shape
    x = audio_embed + sinusoid_pos(Se, d, audio_embed.dtype,
                                   audio_embed.device)
    pos = torch.arange(Se, device=x.device)[None].expand(B, Se)
    x, _, _ = apply_stack(p["enc_blocks"], cfg, x, pos, period=ENC_PERIOD,
                          causal=False, block_q=flags.block_q,
                          remat=flags.remat)
    return rmsnorm(x, p["enc_norm"], cfg.norm_eps)


def _positions(cfg: ModelConfig, batch: Dict[str, torch.Tensor], B: int,
               S: int, device):
    if cfg.rope == "mrope":
        if "rope_pos" in batch:
            return batch["rope_pos"]
        return torch.arange(S, device=device)[None, None].expand(3, B, S)
    return torch.arange(S, device=device)[None].expand(B, S)


def _front(p: Params, cfg: ModelConfig, batch: Dict[str, torch.Tensor],
           flags: RunFlags, dtype):
    """Embedded decoder input, encoder output (or None) and positions."""
    tokens = batch["tokens"]
    B, S = tokens.shape
    x = _embed(p, cfg, tokens, batch.get("vision_embed"), dtype)
    cross_y = None
    if cfg.enc_dec:
        cross_y = _encode(p, cfg, batch["audio_embed"].to(dtype), flags)
        x = x + sinusoid_pos(S, cfg.d_model, x.dtype, x.device)
    return x, cross_y, _positions(cfg, batch, B, S, x.device)


def forward_train(
    p: Union[LM, Params],
    cfg: ModelConfig,
    batch: Dict[str, Any],
    flags: RunFlags = RunFlags(),
    dtype=torch.bfloat16,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Returns (loss, metrics) on the device the weights lie on,
    differentiable in the weights when they require a gradient.  batch:
    tokens, targets [, vision_embed, rope_pos, audio_embed], numpy arrays
    or tensors."""
    check_ported(cfg)
    p = cast_params(p, dtype)
    batch = _on(batch, p["embed"].device)
    x, cross_y, positions = _front(p, cfg, batch, flags, dtype)
    x, _, aux = apply_stack(p["blocks"], cfg, x, positions, causal=True,
                            cross_y=cross_y, block_q=flags.block_q,
                            remat=flags.remat)
    loss, metrics = chunked_ce_loss(p, cfg, x, batch["targets"], flags)
    loss = loss + aux
    metrics["aux_loss"] = aux
    return loss, metrics


def _target_logit(logits: torch.Tensor, tc: torch.Tensor) -> torch.Tensor:
    """``logits[..., tc]``.  On a DTensor (the vocab dim may be sharded on
    the model axis) the one logit is summed out of a mask instead: each
    rank adds its own vocab slice's entry (exactly one is not zero) and the
    partial sums are reduced over (B, chunk), never the logits."""
    if not is_dtensor(logits):
        return logits.gather(-1, tc[..., None])[..., 0]
    V = logits.shape[-1]
    hit = torch.arange(V, device=logits.device) == tc[..., None]
    return torch.where(hit, logits, 0.0).sum(-1)


def chunked_ce_loss(p: Params, cfg: ModelConfig, x: torch.Tensor,
                    targets: torch.Tensor, flags: RunFlags):
    """Cross-entropy without materializing (B, S, vocab) at once: a loop
    over sequence chunks keeps live logits at (B, chunk, vocab); under
    autograd each chunk's logits are recomputed in the backward pass."""
    B, S, d = x.shape
    chunk = min(flags.loss_chunk, S)
    if S % chunk:
        raise ValueError(f"S={S} is not a multiple of loss_chunk={chunk}")

    def one(xc, tc):
        logits = _head(p, cfg, xc).float()               # (B, chunk, V)
        lse = torch.logsumexp(logits, dim=-1)
        tgt = _target_logit(logits, tc)
        if is_dtensor(logits):
            # argmax over a split vocab would gather it: the first index
            # at the row's max is a min over the vocab of the indices that
            # reach it (each rank's slice, then over ranks), as argmax
            # breaks ties
            V = logits.shape[-1]
            at_max = logits == logits.amax(dim=-1, keepdim=True)
            first = torch.where(at_max, torch.arange(V, device=tc.device),
                                V).amin(dim=-1)
            hit = first == tc
        else:
            hit = logits.argmax(-1) == tc
        return sum_all(lse - tgt), sum_all(hit)

    grad = needs_grad(x)
    if grad and is_dtensor(x):   # FSDP's head gathered once, not by chunk
        p = gather_fsdp({k: p[k] for k in ("final_norm", "embed",
                                           "lm_head") if k in p})
    losses, hits = zip(*(checkpointed(one, x[:, c0:c0 + chunk],
                                      targets[:, c0:c0 + chunk].long(),
                                      on=grad)
                         for c0 in range(0, S, chunk)))
    n = B * S
    return torch.stack(losses).sum() / n, {"acc": torch.stack(hits).sum() / n}


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

def make_caches(cfg: ModelConfig, batch: int, cache_len: int,
                dtype=torch.bfloat16, enc_len: int = 0,
                device=None) -> List[Params]:
    return stack_cache_init(cfg, batch, cache_len, dtype,
                            with_cross=cfg.enc_dec, enc_len=enc_len,
                            device=device)


def prefill(
    p: Union[LM, Params],
    cfg: ModelConfig,
    batch: Dict[str, Any],
    caches: List[Params],
    flags: RunFlags = RunFlags(),
    dtype=torch.bfloat16,
) -> Tuple[torch.Tensor, List[Params]]:
    """Run the prompt through the model, filling ``caches`` in place from
    index 0.  batch: tokens [, vision_embed, rope_pos, audio_embed].
    Returns (logits at last position, caches)."""
    check_ported(cfg)
    p = cast_params(p, dtype)
    batch = _on(batch, p["embed"].device)
    x, cross_y, positions = _front(p, cfg, batch, flags, dtype)
    x, caches, _ = apply_stack(
        p["blocks"], cfg, x, positions, causal=True, window=flags.window,
        caches=caches, cache_index=0, cross_y=cross_y, block_q=flags.block_q)
    return _head(p, cfg, x[:, -1:, :]), caches


def decode_step(
    p: Union[LM, Params],
    cfg: ModelConfig,
    caches: List[Params],
    tokens: torch.Tensor,       # (B, 1)
    pos: int,                   # absolute position
    flags: RunFlags = RunFlags(),
    dtype=torch.bfloat16,
) -> Tuple[torch.Tensor, List[Params]]:
    """One decode step: logits for the new token; caches updated in place."""
    check_ported(cfg)
    p = cast_params(p, dtype)
    dev = p["embed"].device
    tokens = torch.as_tensor(tokens, device=dev)
    B = tokens.shape[0]
    x = _embed(p, cfg, tokens, None, dtype)
    if cfg.enc_dec:
        # the sinusoid at the absolute position
        dim = torch.arange(0, cfg.d_model, 2, dtype=torch.float32,
                           device=dev)[None, :]
        ang = (torch.tensor(float(pos), dtype=torch.float32, device=dev)
               / torch.pow(10000.0, dim / cfg.d_model))
        pe = torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)
        x = x + pe[None].to(x.dtype)
    if cfg.rope == "mrope":
        positions = torch.full((3, B, 1), pos, device=dev)
    else:
        positions = torch.full((B, 1), pos, device=dev)
    x, caches, _ = apply_stack(
        p["blocks"], cfg, x, positions, causal=True, window=flags.window,
        caches=caches, cache_index=pos, mla_absorb=flags.mla_absorb,
        block_q=flags.block_q)
    return _head(p, cfg, x), caches
