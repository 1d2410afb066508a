"""AdamW with decoupled weight decay and global-norm gradient clipping.

Counterpart of ``repro.optim.adamw``, operation for operation: the f32
global norm over every leaf, ``clip = min(1, grad_clip / (gnorm + 1e-9))``,
bias corrections from the step taken as f32, the moments updated in f32
(stored in bf16 under ``moment_dtype="bf16"``) and decay added to every
leaf's step.  It is not ``torch.optim.AdamW`` with ``clip_grad_norm_``:
their clip epsilon, their order of decay and update and their f32-only
moments make another update.

The state maps one to one onto the JAX package's: ``{"mu", "nu",
"step"}``, the moments nested like the weights (``LM.tree()``'s layout,
one entry per layer) and ``step`` an int32 scalar on the host, so that the
schedule reads it without waiting for the card.  Weights, gradients and
moments are paired by their keys, as ``jax.tree`` pairs them, never by
position: a state restored from the JAX package lists its keys in another
order.  Weights and moments are updated in place.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from repro_torch.distribution.constraints import is_dtensor
from repro_torch.models.model import map_tree

_F = np.float32


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    # moment dtype: f32 default; bf16 halves the moments' memory
    moment_dtype: str = "f32"


def _tree(p):
    """A module's weights as its nested dicts (``ParamTree.tree``)."""
    return p.tree() if isinstance(p, torch.nn.Module) else p


def leaves(tree) -> List[torch.Tensor]:
    """The tensors of a nested dict/list (or module) in a fixed order: the
    order :func:`adamw_init`'s moments and :func:`unflatten` follow."""
    tree = _tree(tree)
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in leaves(v)]
    if isinstance(tree, list):
        return [t for v in tree for t in leaves(v)]
    return [tree]


def unflatten(like, values) -> Any:
    """``values`` (in :func:`leaves` order) nested as ``like``."""
    it = iter(values)
    return map_tree(lambda _: next(it), _tree(like))


def _zip(trees, path="") -> List[Tuple[torch.Tensor, ...]]:
    """The leaves of ``trees`` matched by key (lists by index), as tuples in
    the first tree's order; raises unless every tree has the first's keys
    and every matched leaf its shape."""
    trees = [_tree(t) for t in trees]
    ref = trees[0]
    kind = next(k for k in (dict, list, torch.Tensor) if isinstance(ref, k))
    for t in trees[1:]:
        if not (isinstance(t, kind)
                and (t.keys() == ref.keys() if kind is dict
                     else len(t) == len(ref) if kind is list
                     else t.shape == ref.shape)):
            raise ValueError(f"adamw_update: {path or '/'} is nested or "
                             f"shaped unlike the weights")
    if isinstance(ref, dict):
        return [z for k in ref for z in _zip([t[k] for t in trees],
                                             f"{path}/{k}")]
    if isinstance(ref, list):
        return [z for i in range(len(ref))
                for z in _zip([t[i] for t in trees], f"{path}/{i}")]
    return [tuple(trees)]


def adamw_init(params, moment_dtype: str = "f32") -> Dict[str, Any]:
    mdt = torch.bfloat16 if moment_dtype == "bf16" else torch.float32

    def zeros(p):   # a DTensor weight's moments placed as the weight
        return torch.zeros_like(p, dtype=mdt)

    tree = _tree(params)
    return {"mu": map_tree(zeros, tree), "nu": map_tree(zeros, tree),
            "step": torch.zeros((), dtype=torch.int32)}


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in leaves(tree)))


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, params, grads, state,
                 lr_scale=1.0) -> Tuple[Any, Dict[str, Any], Dict]:
    """One update of ``params`` (an ``LM`` or nested dicts of tensors) by
    ``grads`` (nested as ``params``).  Returns (params, state, metrics);
    the weights and moments are the ones given, written in place."""
    quads = _zip([params, grads, state["mu"], state["nu"]])
    gnorm = global_norm([g for _, g, _, _ in quads])
    dev = gnorm.device

    def f32(x):
        # a scalar on the card divides exactly; a host scalar would be
        # turned into a product by its reciprocal there
        return torch.tensor(x, dtype=torch.float32, device=dev)

    clip = torch.clamp(f32(cfg.grad_clip) / (gnorm + 1e-9), max=1.0)
    step = int(state["step"]) + 1
    b1c = f32(_F(1.0) - _F(cfg.b1) ** _F(step))
    b2c = f32(_F(1.0) - _F(cfg.b2) ** _F(step))
    lr = float(_F(cfg.lr) * _F(lr_scale))
    for p, g, mu, nu in quads:
        if is_dtensor(g):   # reduced into its moments' layout (ZeRO-1)
            g = g.redistribute(mu.device_mesh, mu.placements)
        g = g.float() * clip
        m = mu.float().mul_(cfg.b1).add_(g * (1 - cfg.b1))  # in place if f32
        v = nu.float().mul_(cfg.b2).add_(g * (1 - cfg.b2) * g)
        if mu.dtype != torch.float32:
            mu.copy_(m)
            nu.copy_(v)
        upd = (m / b1c).div_(torch.sqrt(v / b2c).add_(cfg.eps))
        upd.add_(p.float() * cfg.weight_decay)
        if p.dtype == torch.float32:
            p.sub_(upd.mul_(lr))
        else:
            p.copy_(p.float() - upd.mul_(lr))
    state = dict(state, step=torch.tensor(step, dtype=torch.int32))
    return params, state, {"grad_norm": gnorm}
