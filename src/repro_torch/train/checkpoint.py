"""Checkpointing in the JAX package's on-disk format, numpy only.

Counterpart of ``repro.train.checkpoint``: ``ckpt_{step:08d}.npz`` with
'/'-joined keys (``params/blocks/pos0/mixer/wq``, ``opt/mu/...``,
``opt/nu/...``, ``opt/step``) and a ``latest.json`` naming it.  The
weights and moments are written in the JAX layout (``blocks`` stacked over
the periods, :func:`repro_torch.models.model.to_reference`), so the JAX
package's ``load_checkpoint`` restores what the port saved and the port
restores what the JAX package saved.  bf16 leaves (``moment_dtype="bf16"``)
are stored as numpy stores JAX's: 2-byte records of their bits.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch._device import resolve
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import (
    LM,
    from_reference,
    to_reference,
    unstack_reference,
)


def _flatten(tree, prefix: str = "") -> Dict[str, np.ndarray]:
    flat: Dict[str, np.ndarray] = {}
    for k, v in tree.items():
        key = f"{prefix}{k}"
        if isinstance(v, dict):
            flat.update(_flatten(v, key + "/"))
        else:
            flat[key] = np.asarray(v)
    return flat


def save_checkpoint(dirname: str, params: LM, opt_state=None,
                    step: int = 0) -> str:
    """Write ``params`` (an :class:`LM`) and AdamW's state (or None) as
    step ``step``; returns the file's path.  On a mesh (DTensor leaves)
    every rank calls it: each leaf is gathered whole on every rank and
    rank 0 writes the file, in the same format."""
    import torch.distributed as dist
    cfg = params.cfg
    payload: Dict[str, Any] = {"params": to_reference(params, cfg)}
    if opt_state is not None:
        payload["opt"] = {"mu": to_reference(opt_state["mu"], cfg),
                          "nu": to_reference(opt_state["nu"], cfg),
                          "step": np.asarray(int(opt_state["step"]),
                                             np.int32)}
    path = os.path.join(dirname, f"ckpt_{step:08d}.npz")
    if dist.is_initialized() and dist.get_rank() != 0:
        return path
    os.makedirs(dirname, exist_ok=True)
    np.savez(path, **_flatten(payload))
    with open(os.path.join(dirname, "latest.json"), "w") as f:
        json.dump({"path": path, "step": step}, f)
    return path


def load_checkpoint(dirname: str, cfg: ModelConfig, device="cuda"
                    ) -> Tuple[LM, Optional[Dict[str, Any]], int]:
    """Returns (params, opt_state, step) of the latest checkpoint in
    ``dirname``, the weights as an :class:`LM` of ``cfg`` and the moments
    nested like them, on ``device``; opt_state is None if none was
    saved."""
    dev = resolve(device)
    with open(os.path.join(dirname, "latest.json")) as f:
        meta = json.load(f)
    tree: Dict[str, Any] = {}
    with np.load(meta["path"]) as data:
        for key in data.files:
            *path, leaf = key.split("/")
            node = tree
            for part in path:
                node = node.setdefault(part, {})
            node[leaf] = data[key]
    params = from_reference(tree["params"], cfg, device=dev)
    opt = tree.get("opt")
    if opt is not None:
        like = params.tree()
        opt = {"mu": _nest_like(like, unstack_reference(opt["mu"], cfg, dev)),
               "nu": _nest_like(like, unstack_reference(opt["nu"], cfg, dev)),
               "step": torch.tensor(int(opt["step"]), dtype=torch.int32)}
    return params, opt, meta["step"]


def _nest_like(like, tree):
    """``tree`` with the keys of ``like`` in ``like``'s order: the loaded
    moments listed as the weights they belong to (``LM.tree()`` lists a
    layer's own tensors before its sub-modules; the npz file sorts its
    keys)."""
    if isinstance(like, dict):
        if like.keys() != tree.keys():
            raise ValueError(f"checkpoint: moments {sorted(tree)} against "
                             f"weights {sorted(like)}")
        return {k: _nest_like(v, tree[k]) for k, v in like.items()}
    if isinstance(like, list):
        return [_nest_like(a, b) for a, b in zip(like, tree, strict=True)]
    if tree.shape != like.shape:
        raise ValueError(f"checkpoint: a moment of shape {tuple(tree.shape)}"
                         f" against a weight of {tuple(like.shape)}")
    return tree
