"""Activation sharding constraints, mesh-optional.

Counterpart of ``repro.distribution.constraints``.  Model code calls
:func:`constrain` with a logical spec; under an ambient mesh
(:func:`use_mesh`, the counterpart of ``jax.set_mesh``) a DTensor is
redistributed to it (JAX's ``with_sharding_constraint``): the batch dim
stays on the data axes through microbatch slicing, MoE dispatch and the
residual stream, and a row-parallel product's partial sums are reduced
where the stream is pinned.  A plain tensor, or any tensor without a mesh,
is returned as it is, so the model stays mesh-agnostic and the
one-device path computes exactly what it did without these calls.
"""

from __future__ import annotations

import contextlib
from typing import Any, Iterator, Optional, Tuple

import torch

_MESH = None
_DP_OVERRIDE: Optional[Tuple[str, ...]] = None


@contextlib.contextmanager
def use_mesh(mesh) -> Iterator[Any]:
    """Make ``mesh`` (a ``DeviceMesh`` with named dims) the ambient mesh
    inside the block.  Plain tensors that meet DTensors there (positions,
    masks, constants the model makes) count as replicated, and a product
    whose sums are split over ranks (a row-parallel projection, or one
    through a split width) is reduced where it is made
    (:class:`_ReduceProducts`)."""
    from torch.distributed.tensor.experimental import implicit_replication
    global _MESH
    prev, _MESH = _MESH, mesh
    try:
        with implicit_replication(), _ReduceProducts():
            yield mesh
    finally:
        _MESH = prev


class _ReduceProducts(torch.overrides.TorchFunctionMode):
    """Under a mesh: a matrix product that comes out as partial sums is
    reduced at once, its batch dim kept on the data axes and its last dim
    kept split where it is.  Left partial, DTensor would reduce it at the
    next nonlinearity by scattering it over whichever dim it picks (the
    sequence, say), a layout the next product cannot take.  Only the
    forward's products pass here: autograd's backward ops do not, nor a
    checkpointed layer's recomputation, whose partial products meet the
    residual stream's pins (:func:`constrain_batch_dim`, which pins the
    gradient too)."""

    _PRODUCTS = {torch.matmul, torch.Tensor.matmul, torch.Tensor.__matmul__,
                 torch.einsum}

    def __torch_function__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func in self._PRODUCTS and is_dtensor(out) and out.ndim >= 2 \
                and any(p.is_partial() for p in out.placements):
            last = spec_now(out)[-1]
            out = constrain(out, batch_entry(out.shape[0]),
                            *([None] * (out.ndim - 2)), last)
        return out


def current_mesh():
    return _MESH


def _axes() -> Optional[dict]:
    if _MESH is None or not _MESH.mesh_dim_names:
        return None
    return dict(zip(_MESH.mesh_dim_names, tuple(_MESH.shape)))


def set_dp_axes(axes: Optional[Tuple[str, ...]]) -> None:
    """Override which mesh axes count as data-parallel (the launcher sets
    ("pod", "data", "model") for pure-DP small-model policies)."""
    global _DP_OVERRIDE
    _DP_OVERRIDE = axes


def batch_axes() -> Optional[Any]:
    axes = _axes()
    if axes is None:
        return None
    wanted = _DP_OVERRIDE if _DP_OVERRIDE is not None else ("pod", "data")
    dp = tuple(a for a in wanted if a in axes)
    if not dp:
        return None
    return dp if len(dp) > 1 else dp[0]


def model_axis_size() -> int:
    """Size of the "model" mesh axis (0 when absent / no mesh)."""
    axes = _axes()
    if axes is None or "model" not in axes:
        return 0
    if _DP_OVERRIDE and "model" in _DP_OVERRIDE:
        return 0  # pure-DP: the model axis is spent on the batch
    return axes["model"]


def is_dtensor(x) -> bool:
    """Whether ``x`` is a DTensor (without importing DTensor for a plain
    tensor's sake)."""
    if type(x) is torch.Tensor or not isinstance(x, torch.Tensor):
        return False
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def constrain(x, *spec):
    """``x`` redistributed to ``spec`` (one entry per dim, trailing dims
    replicated) when it is a DTensor under an ambient mesh; else ``x``.
    Raises ``ValueError`` if a sharded dim does not divide its axes."""
    if _MESH is None or not is_dtensor(x):
        return x
    from repro_torch.distribution.sharding import placements
    axes = _axes()
    spec = tuple(spec) + (None,) * (x.ndim - len(spec))
    for dim, e in enumerate(spec):
        total = 1
        for a in (e if isinstance(e, tuple) else (e,) if e else ()):
            total *= axes[a]
        if x.shape[dim] % total:
            raise ValueError(f"constrain: dim {dim} of {tuple(x.shape)} "
                             f"does not divide {e} ({total})")
    want = placements(spec, _MESH)
    if tuple(want) == tuple(x.placements):
        return x
    return x.redistribute(_MESH, want)


def dp_size() -> int:
    """Ranks of the data-parallel axes (1 without a mesh)."""
    dp = batch_axes()
    if dp is None:
        return 1
    axes, total = _axes(), 1
    for a in (dp if isinstance(dp, tuple) else (dp,)):
        total *= axes[a]
    return total


def constrain_batch_dim(x, bdim: int = 0):
    """Pin x's ``bdim`` to the data-parallel axes (if the dim divides; a
    DTensor whose batch does not divide them is pinned replicated, its
    partial sums reduced).  Its gradient is pinned alike, as GSPMD pins a
    constrained value's cotangent: partial sums coming back from the loss
    or a row-parallel product are reduced here, where the residual stream
    is, not met by weights DTensor would gather."""
    dp = batch_axes()
    if dp is None:
        return x
    total = dp_size()
    spec = [None] * x.ndim
    if x.shape[bdim] % total == 0 and x.shape[bdim] >= total:
        spec[bdim] = dp
    elif not is_dtensor(x):
        return x
    x = constrain(x, *spec)
    if is_dtensor(x) and x.requires_grad and torch.is_grad_enabled():
        x = _PinGrad.apply(x)
    return x


class _PinGrad(torch.autograd.Function):
    """The identity, whose gradient is redistributed to the placements
    of its input (partial sums reduced)."""

    @staticmethod
    def forward(ctx, x):
        ctx.mesh, ctx.placements = x.device_mesh, tuple(x.placements)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        if is_dtensor(g) and tuple(g.placements) != ctx.placements:
            g = g.redistribute(ctx.mesh, ctx.placements)
        return g


def local_call(fn, args, in_specs, out_specs, grad_partial=None):
    """``fn`` on each rank's own shards (JAX's ``shard_map``): every
    argument with a spec in ``in_specs`` (a DTensor) is redistributed to
    that spec and handed to ``fn`` as its local tensor; arguments whose
    spec is None are passed as they are.  ``fn`` returns a tuple, and
    output i comes back as a DTensor placed by ``out_specs[i]`` = (spec,
    the axes over which it is a partial sum).  ``grad_partial[i]`` names
    the axes over which rank-local gradients of argument i are partial
    sums (a weight replicated over the batch's axes).  Differentiable:
    ``to_local`` and ``from_local`` carry the gradients across."""
    from torch.distributed.tensor import DTensor
    mesh = _MESH
    local = []
    for i, (a, spec) in enumerate(zip(args, in_specs)):
        if spec is None:
            local.append(a)
            continue
        want = _with_partial(spec, ())
        if tuple(a.placements) != tuple(want):
            a = a.redistribute(mesh, want)
        gp = grad_partial[i] if grad_partial else ()
        local.append(a.to_local(grad_placements=_with_partial(spec, gp)))
    outs = fn(*local)
    return tuple(DTensor.from_local(o, mesh, _with_partial(*out),
                                    run_check=False)
                 for o, out in zip(outs, out_specs))


def _with_partial(spec, partial_axes):
    """Placements of ``spec`` on the ambient mesh, ``Partial()`` (a sum)
    on the mesh dims named in ``partial_axes``."""
    from torch.distributed.tensor import Partial
    from repro_torch.distribution.sharding import placements
    out = placements(spec, _MESH)
    return [Partial() if name in partial_axes else p
            for name, p in zip(_MESH.mesh_dim_names, out)]


def batch_entry(n: int):
    """The data-parallel spec entry for a batch dim of ``n`` rows: the
    batch axes when ``n`` divides them, else None (replicated)."""
    dp = batch_axes()
    total = dp_size()
    return dp if dp is not None and n % total == 0 and n >= total else None


def model_entry(n: int):
    """"model" for a dim of ``n`` entries that the model axis divides,
    else None."""
    m = model_axis_size()
    return "model" if m and n % m == 0 else None


def axes_of(entry) -> Tuple[str, ...]:
    """The mesh axes a spec entry names."""
    return entry if isinstance(entry, tuple) else (entry,) if entry else ()


def sum_all(t: torch.Tensor) -> torch.Tensor:
    """``t.sum()``.  On a DTensor each rank sums its own shard and the
    result is a partial sum over the axes sharding ``t``: the gradient
    comes back to every rank in ``t``'s placements, never gathered."""
    if not is_dtensor(t):
        return t.sum()
    spec = spec_now(t)
    parts = tuple(a for e in spec for a in axes_of(e))
    (s,) = local_call(lambda a: (a.sum(),), (t,), (spec,), [((), parts)])
    return s


def spec_now(x) -> Tuple[Any, ...]:
    """The spec of a DTensor's current placements (partial sums read as
    unsplit)."""
    from repro_torch.distribution.sharding import spec_of
    return spec_of(x.placements, x.device_mesh, x.ndim)


def shard_index(entry) -> int:
    """This rank's block along a dim split over ``entry``'s axes (major
    first, as :func:`~repro_torch.distribution.sharding.placements` splits
    it); 0 for an unsplit dim."""
    idx = 0
    for a in axes_of(entry):
        idx = idx * _MESH.size(_MESH.mesh_dim_names.index(a)) \
            + _MESH.get_local_rank(a)
    return idx


def reduce_over(t: torch.Tensor, op: str, entry) -> torch.Tensor:
    """A rank-local tensor reduced (``"sum"`` or ``"max"``) over the mesh
    axes ``entry`` names, inside a :func:`local_call`; ``t`` as it is for
    none."""
    from torch.distributed import _functional_collectives as funcol
    for a in axes_of(entry):
        t = funcol.all_reduce(t, op, (_MESH, _MESH.mesh_dim_names.index(a)))
    return t


def write_slots(cache: torch.Tensor, slot: int, vals: torch.Tensor) -> None:
    """``cache[:, slot:slot + S] = vals`` in place.  On a cache whose
    sequence dim is split (the batch-1 rule of ``cache_specs``) each rank
    writes the part of ``vals`` that falls in its own slots, taken from
    ``vals`` placed as the cache with its sequence whole (DTensor's slice
    assignment would gather the cache first, and write into the gathered
    copy)."""
    S = vals.shape[1]
    spec = spec_now(cache) if is_dtensor(cache) else (None, None)
    if spec[1] is None:
        cache[:, slot:slot + S] = vals.to(cache.dtype)
        return
    local = cache.to_local()
    n = local.shape[1]
    lo = shard_index(spec[1]) * n
    a, b = max(slot, lo), min(slot + S, lo + n)
    if a >= b:
        return
    want = _with_partial((spec[0], None) + tuple(spec[2:]), ())
    if tuple(vals.placements) != tuple(want):
        vals = vals.redistribute(_MESH, want)
    vals = vals.to_local()
    local[:, a - lo:b - lo] = vals[:, a - slot:b - slot].to(local.dtype)


def gather_fsdp(tree):
    """Each DTensor weight of ``tree`` (nested dicts) made whole over the
    data axes where FSDP split it, its other splits kept: GSPMD's choice
    for a step that trains, a layer's weights gathered where they are
    used (their gradients reduce-scattered back by autograd).  Left split,
    DTensor would keep the weight and move the activations instead,
    gathering the batch and reducing the products over it.  The identity
    without a mesh."""
    if _MESH is None:
        return tree
    if isinstance(tree, dict):
        return {k: gather_fsdp(v) for k, v in tree.items()}
    if not is_dtensor(tree):
        return tree
    data = ("pod", "data")
    spec = [tuple(a for a in axes_of(e) if a not in data)
            for e in spec_now(tree)]
    return constrain(tree, *(e if len(e) > 1 else (e[0] if e else None)
                             for e in spec))


def whole(w: torch.Tensor) -> torch.Tensor:
    """A small weight (a norm's scale, a token-shift mix) replicated where
    it meets the residual stream: its split would otherwise split the
    stream's width, and the next product's sums.  The identity without a
    mesh."""
    if _MESH is None or not is_dtensor(w):
        return w
    return constrain(w, *([None] * w.ndim))


def whole_last(x: torch.Tensor) -> torch.Tensor:
    """A DTensor with its last dim whole (gathered where it was split),
    every other dim placed as it was; partial sums reduced."""
    return constrain(x, *spec_now(x)[:-1], None)
