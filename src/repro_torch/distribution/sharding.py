"""Sharding rules: parameter / optimiser / cache / batch trees → specs and
DTensor placements.

Counterpart of ``repro.distribution.sharding``, rule for rule.  Scheme
(Megatron-style tensor parallel on the "model" axis + data parallel on
("pod", "data") + ZeRO-1 optimiser-state sharding):

* column-parallel (shard output dim): wq/wk/wv/wi/up-projections, router,
  expert dim of MoE weights (expert parallel) when divisible;
* row-parallel (shard input dim): wo/down-projections;
* embeddings shard the vocab dim (fallback d_model when vocab % model != 0,
  e.g. whisper's 51865);
* anything non-divisible falls back to the next divisible dim, else
  replication — this is what absorbs head counts (9, 12, 40, 48) that do
  not divide the 16-way model axis;
* optimiser moments inherit the parameter spec plus "data" on the largest
  remaining free dim (ZeRO-1);
* decode caches shard batch on "data" (("pod", "data") multi-pod); the
  batch=1 long-context shape shards the cache *sequence* dim on "data"
  instead (cache sequence parallelism).

A spec is a tuple with one entry per tensor dim, in ``PartitionSpec``'s
terms: ``None`` (replicated), a mesh axis name, or a tuple of names (one
dim split over several axes, major first).  :func:`spec_for` and the
``*_specs`` functions are pure functions of key paths, shapes and the mesh
axis sizes (a ``{name: size}`` dict); :func:`placements` turns a spec into
DTensor placements on a ``DeviceMesh``, :func:`distribute` a tree of
tensors into DTensors.

The port's layout is not the JAX package's.  JAX stacks each period's
leaves on a leading ``n_periods`` axis and its rules skip that axis; the
port holds one dict per layer (``blocks.<i>.…``), so a layer's spec is
JAX's spec of the stacked leaf without its first entry, and the caches'
batch axis is 0, not 1.  JAX's FSDP / ZeRO-1 choice of the largest free
dim never takes the stacked axis: it needs at least ``8 · data`` entries
divisible by ``data`` (128 on the production meshes), more than any
configuration's period count (at most 80), so dropping that axis changes
no choice there.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Tuple

import torch

from repro_torch.models.config import InputShape, ModelConfig

Spec = Tuple[Any, ...]
Axes = Dict[str, int]

# param keys that are column-parallel (shard LAST dim) / row-parallel (shard
# first dim).  Keys not listed fall back to shape-driven choice.
_COL = {"wq", "wk", "wv", "wi", "wg", "wgate", "wup", "wr", "wdq", "wuq",
        "wdkv", "wuk", "wuv", "wkr", "in_x", "in_z", "dt_proj",
        "shared_wg", "shared_wu", "router", "wA", "wB",
        "bq", "bk", "bv", "conv_b", "dt_bias", "D"}
_ROW = {"wo", "out_proj", "shared_wo"}
# MoE expert weights: shard expert dim when divisible (expert parallel)
_EXPERT = {"we_g", "we_u", "we_o"}


def _div(n: int, size: int) -> bool:
    return size > 0 and n % size == 0


def spec_for(name: str, shape: Sequence[int], model: int) -> Spec:
    """The tensor-parallel spec of a leaf called ``name`` (its last key)
    of shape ``shape`` on a model axis of ``model`` ranks."""
    nd = len(shape)
    spec = [None] * nd

    def try_dim(i: int) -> bool:
        if 0 <= i < nd and _div(shape[i], model):
            spec[i] = "model"
            return True
        return False

    if name in _EXPERT and nd >= 2:
        # (E, d, f): expert dim first; else Megatron TP inside experts —
        # up-projections shard their OUTPUT dim (f, last), the
        # down-projection its CONTRACTING dim (ffe, second-to-last)
        if not try_dim(0):
            if name == "we_o":
                try_dim(nd - 2) or try_dim(nd - 1)
            else:
                try_dim(nd - 1) or try_dim(nd - 2)
    elif name == "embed":
        try_dim(0) or try_dim(1)
    elif name == "lm_head":
        try_dim(1) or try_dim(0)
    elif name in _COL:
        any(try_dim(i) for i in range(nd - 1, -1, -1))
    elif name in _ROW:
        try_dim(0) or try_dim(nd - 1)
    elif nd >= 2:   # fallback: prefer last dim, then earlier ones
        any(try_dim(i) for i in range(nd - 1, -1, -1))
    elif nd == 1 and shape[0] >= 4096:
        try_dim(0)
    return tuple(spec)


def _zero1(spec: list, shape: Sequence[int], data: int) -> None:
    """"data" on the largest free dim that it divides, holding at least
    ``8 · data`` entries (FSDP / ZeRO-1)."""
    free = sorted((i for i, s in enumerate(spec) if s is None),
                  key=lambda i: -shape[i])
    for i in free:
        if _div(shape[i], data) and shape[i] >= data * 8:
            spec[i] = "data"
            return


def _walk(tree, fn, path: Tuple = ()):
    """``fn(path, leaf)`` over nested dicts and lists, nested as given."""
    if isinstance(tree, torch.nn.Module):
        tree = tree.tree()
    if isinstance(tree, dict):
        return {k: _walk(v, fn, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_walk(v, fn, path + (i,)) for i, v in enumerate(tree)]
    return fn(path, tree)


def param_specs(axes: Axes, tree, fsdp: bool = False,
                pure_dp: bool = False):
    """Specs for a parameter tree (tensors, meta tensors or anything with a
    ``shape``), nested as it.  ``fsdp`` additionally shards the largest
    free dim over "data"; ``pure_dp`` replicates every weight."""
    model, data = axes.get("model", 1), axes.get("data", 1)

    def f(path, leaf):
        shape = tuple(leaf.shape)
        spec = ([None] * len(shape) if pure_dp
                else list(spec_for(str(path[-1]), shape, model)))
        if fsdp:
            _zero1(spec, shape, data)
        return tuple(spec)

    return _walk(tree, f)


def opt_specs(axes: Axes, opt_state, fsdp: bool = False,
              pure_dp: bool = False):
    """Moments: the tensor-parallel spec plus ZeRO-1 "data" sharding on
    the largest free dim; ``step`` replicated.  ``fsdp`` changes nothing
    here: the JAX package's rule ignores it too."""
    model, data = axes.get("model", 1), axes.get("data", 1)

    def f(path, leaf):
        shape = tuple(leaf.shape)
        if path and path[-1] == "step":
            return ()
        spec = ([None] * len(shape) if pure_dp
                else list(spec_for(str(path[-1]), shape, model)))
        _zero1(spec, shape, data)
        return tuple(spec)

    return _walk(opt_state, f)


def _dp(axes: Axes, wanted: Sequence[str]):
    names = [a for a in wanted if a in axes]
    total = 1
    for a in names:
        total *= axes[a]
    return names, total


def _entry(names: Sequence[str]):
    return tuple(names) if len(names) > 1 else (names[0] if names else None)


def batch_specs(axes: Axes, batch, shape: Optional[InputShape] = None,
                pure_dp: bool = False):
    """Batch dim over ("pod", "data") when divisible (``rope_pos``'s is
    axis 1); ``pure_dp`` folds the idle "model" axis into the batch axes.
    ``shape`` is unused, as in the JAX package."""
    names, dp = _dp(axes, ("pod", "data", "model") if pure_dp
                    else ("pod", "data"))

    def f(path, leaf):
        dims = tuple(leaf.shape)
        bdim = 1 if path and path[-1] == "rope_pos" else 0
        spec = [None] * len(dims)
        if dims[bdim] % dp == 0 and dims[bdim] >= dp:
            spec[bdim] = _entry(names)
        elif "data" in axes and dims[bdim] % axes["data"] == 0 \
                and dims[bdim] >= axes["data"]:
            spec[bdim] = "data"
        return tuple(spec)

    return _walk(batch, f)


def cache_specs(axes: Axes, caches, shape: InputShape,
                cfg: Optional[ModelConfig] = None, pure_dp: bool = False):
    """Decode caches, one dict a layer: k/v (B,S,KV,hd) · ckv (B,S,kvl) ·
    krope (B,S,r) · mamba h (B,di,ds) · conv (B,dc-1,di) · rwkv tmix_wkv
    (B,H,hd,hd) · shifts (B,d) · cross k/v (B,Se,KV,hd).  Batch on the data
    axes (falling back to smaller subsets of them); at batch 1 the
    sequence dim on "data" instead."""
    model = 0 if pure_dp else axes.get("model", 1)   # 0: _div() rejects
    data = axes.get("data", 1)
    names, _ = _dp(axes, ("pod", "data", "model") if pure_dp
                   else ("pod", "data"))
    seq_shard = shape.global_batch == 1

    def f(path, leaf):
        name, dims = path[-1], tuple(leaf.shape)
        spec = [None] * len(dims)
        if not seq_shard:
            for cand in (names, names[:-1], names[:1]):
                cdp = 1
                for a in cand:
                    cdp *= axes[a]
                if cand and _div(dims[0], cdp) and dims[0] >= cdp:
                    spec[0] = _entry(cand)
                    break

        def model_on(*dims_in_order):
            for i in dims_in_order:
                if _div(dims[i], model):
                    spec[i] = "model"
                    return

        if name in ("k", "v", "cross_k", "cross_v", "ckv", "krope"):
            if seq_shard and _div(dims[1], data):
                spec[1] = "data"
            model_on(*((2, 3) if name in ("k", "v", "cross_k", "cross_v")
                       else (2,)))
        elif name in ("h", "tmix_wkv", "tmix_shift", "cmix_shift"):
            model_on(1)
        elif name == "conv":
            model_on(2)
        return tuple(spec)

    return _walk(caches, f)


# ---------------------------------------------------------------------------
# specs → DTensor placements
# ---------------------------------------------------------------------------

def mesh_axes(mesh) -> Axes:
    """``{axis name: size}`` of a ``DeviceMesh`` (or anything with
    ``mesh_dim_names`` and ``shape``)."""
    return dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))


def placements(spec: Spec, mesh) -> list:
    """DTensor placements of ``spec`` on ``mesh``: mesh dim ``m`` is
    ``Shard(i)`` where entry i names it (a tuple entry names its axes
    major first, as DTensor shards left to right), else ``Replicate()``."""
    from torch.distributed.tensor import Replicate, Shard
    out = []
    for name in mesh.mesh_dim_names:
        dim = next((i for i, e in enumerate(spec)
                    if e == name or (isinstance(e, tuple) and name in e)),
                   None)
        out.append(Replicate() if dim is None else Shard(dim))
    return out


def spec_of(placements_: Sequence, mesh, ndim: int) -> Spec:
    """The inverse of :func:`placements`."""
    from torch.distributed.tensor import Shard
    entries = [[] for _ in range(ndim)]
    for name, pl in zip(mesh.mesh_dim_names, placements_):
        if isinstance(pl, Shard):
            entries[pl.dim].append(name)
    return tuple(_entry(e) for e in entries)


def distribute(tree, specs, mesh, copy: bool = True):
    """Every tensor of ``tree`` as a DTensor with its spec's placements
    (``specs`` nested as ``tree``).  Each rank passes the same full
    tensors and keeps its shard (no communication); non-tensors are
    returned as they are.  ``copy=False`` keeps each shard as a view of
    the full tensor (no memory of its own: the full tensors may be
    another process's, shared over CUDA IPC)."""
    from torch.distributed.tensor import DTensor, distribute_tensor

    def f(path, leaf):
        spec = specs
        for k in path:
            spec = spec[k]
        if not isinstance(leaf, torch.Tensor):
            return leaf
        if copy:
            return distribute_tensor(leaf, mesh, placements(spec, mesh),
                                     src_data_rank=None)
        return DTensor.from_local(_shard_view(leaf, spec, mesh), mesh,
                                  placements(spec, mesh), run_check=False)

    return _walk(tree, f)


def _shard_view(t: torch.Tensor, spec: Spec, mesh) -> torch.Tensor:
    """This rank's block of ``t`` under ``spec`` (every split dim divides),
    as a view."""
    names = list(mesh.mesh_dim_names)
    for dim, e in enumerate(spec):
        idx, total = 0, 1
        for a in (e if isinstance(e, tuple) else (e,) if e else ()):
            n = mesh.size(names.index(a))
            idx, total = idx * n + mesh.get_local_rank(a), total * n
        if total > 1:
            step = t.shape[dim] // total
            t = t.narrow(dim, idx * step, step)
    return t


def local_bytes(tree, specs, axes: Axes) -> int:
    """Bytes one rank holds of ``tree`` under ``specs``: each leaf's size
    over the product of the axes sharding it (every sharded dim
    divides, as the rules require)."""
    total = 0

    def f(path, leaf):
        nonlocal total
        spec = specs
        for k in path:
            spec = spec[k]
        n = leaf.numel() * leaf.element_size()
        for e in spec:
            for a in (e if isinstance(e, tuple) else (e,) if e else ()):
                n //= axes[a]
        total += n

    _walk(tree, f)
    return total
