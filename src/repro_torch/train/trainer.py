"""Training loop: the train step (loss, gradients, AdamW) and its host loop.

Counterpart of ``repro.train.trainer``.  ``make_train_step`` returns
(params, opt_state, batch) -> (params, opt_state, metrics) as there; here
the weights (an ``LM``, f32 masters) and the moments are updated in place
and returned.  The loss runs in ``TrainConfig.dtype`` (bf16 by default)
through ``cast_params``, whose casts carry the gradients back to the f32
leaves.  The ``Trainer`` adds the host loop: data, logging, a checkpoint
at the end.  It runs on the card unless told ``device="cpu"`` (or given
weights on the CPU).

On a mesh (``mesh=``, a ``DeviceMesh``; the weights and moments DTensors
placed by ``repro_torch.distribution.sharding``, as the launcher places
them) every rank runs the same step: each host batch (every microbatch
on its own) is placed with ``batch_specs``, the model runs under the
mesh's constraints, the loss is made whole on every rank before its
gradient, and AdamW updates the DTensor leaves where they lie.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, Iterator, List, Optional

import torch

from repro_torch.distribution.constraints import is_dtensor, use_mesh
from repro_torch.distribution.sharding import (
    batch_specs,
    distribute,
    mesh_axes,
)
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import LM, RunFlags, forward_train, init_lm
from repro_torch.optim.adamw import (
    AdamWConfig,
    adamw_init,
    adamw_update,
    leaves,
    unflatten,
)
from repro_torch.optim.schedule import cosine_schedule
from repro_torch.train.checkpoint import save_checkpoint


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    steps: int = 200
    warmup: int = 20
    log_every: int = 10
    ckpt_dir: Optional[str] = None   # a checkpoint at the end when set
    seed: int = 0
    dtype: Any = torch.bfloat16
    microbatches: int = 1        # gradient accumulation (activation memory ÷ mb)
    optim: AdamWConfig = AdamWConfig()
    flags: RunFlags = RunFlags()


def _split_micro(batch: Dict, mb: int) -> List[Dict]:
    """The batch as ``mb`` microbatches of consecutive rows: (B, ...)
    leaves split on axis 0, ``rope_pos`` (3, B, S) on axis 1."""
    out: List[Dict] = [{} for _ in range(mb)]
    for name, leaf in batch.items():
        bdim = 1 if name == "rope_pos" else 0
        B = leaf.shape[bdim]
        if B % mb:
            raise ValueError(f"{name}: batch {B} does not split into {mb} "
                             f"microbatches")
        for i in range(mb):
            out[i][name] = (leaf[i * B // mb:(i + 1) * B // mb] if bdim == 0
                            else leaf[:, i * B // mb:(i + 1) * B // mb])
    return out


def host_value(v) -> torch.Tensor:
    """A metric as a plain tensor (a DTensor gathered whole)."""
    return v.full_tensor() if is_dtensor(v) else v


def make_train_step(cfg: ModelConfig, tc: TrainConfig, mesh=None,
                    pure_dp: bool = False) -> Callable:
    """(params, opt_state, batch) -> (params, opt_state, metrics), the
    weights and moments updated in place.

    With ``microbatches > 1`` the gradients of each microbatch are summed
    in f32 and divided by their number, as is the loss: the activations
    held scale with the microbatch, not the batch.  With a ``mesh`` the
    weights and moments are DTensors on it and each host batch is placed
    by ``batch_specs`` (``pure_dp``: over the model axis too).
    """

    def place(batch):
        if mesh is None:
            return batch
        host = {k: torch.as_tensor(v).to(mesh.device_type)
                for k, v in batch.items()}
        return distribute(host, batch_specs(mesh_axes(mesh), host,
                                            pure_dp=pure_dp), mesh)

    def loss_and_grads(params: LM, batch):
        loss, metrics = forward_train(params, cfg, place(batch), tc.flags,
                                      dtype=tc.dtype)
        if is_dtensor(loss):
            # the whole loss on every rank, so its gradient starts at 1
            from torch.distributed.tensor import Replicate
            loss = loss.redistribute(loss.device_mesh,
                                     [Replicate()] * loss.device_mesh.ndim)
        # a leaf the loss does not reach gets zeros, as under jax.grad
        grads = torch.autograd.grad(loss, leaves(params), allow_unused=True,
                                    materialize_grads=True)
        return loss.detach(), metrics, grads

    def train_step(params: LM, opt_state, batch):
        if mesh is None:
            return one_step(params, opt_state, batch)
        with use_mesh(mesh):
            return one_step(params, opt_state, batch)

    def one_step(params: LM, opt_state, batch):
        params.requires_grad_()
        mb = tc.microbatches
        if mb > 1:
            # split on the host, then placed: every microbatch's rows stay
            # on the data axes
            grads = loss = acc = None
            for part in _split_micro(batch, mb):
                l_i, m_i, g_i = loss_and_grads(params, part)
                g_i = [g.float() for g in g_i]
                if grads is None:
                    grads, loss, acc = g_i, l_i, m_i["acc"]
                else:
                    grads = [a + g for a, g in zip(grads, g_i)]
                    loss, acc = loss + l_i, acc + m_i["acc"]
            grads = [g / mb for g in grads]
            loss = loss / mb
            metrics = {"acc": acc / mb}
        else:
            loss, metrics, grads = loss_and_grads(params, batch)
            metrics = {k: v.detach() for k, v in metrics.items()}
        lr_scale = cosine_schedule(opt_state["step"], tc.warmup, tc.steps)
        params, opt_state, om = adamw_update(
            tc.optim, params, unflatten(params, grads), opt_state, lr_scale)
        metrics = dict(metrics, loss=loss, lr_scale=lr_scale, **om)
        return params, opt_state, metrics

    return train_step


class Trainer:
    def __init__(self, cfg: ModelConfig, tc: TrainConfig, data: Iterator[Dict],
                 params: Optional[LM] = None, device="cuda", mesh=None,
                 opt_state=None, pure_dp: bool = False):
        """``params`` (f32 masters) default to ``init_lm(cfg, tc.seed)`` on
        ``device``; given, they are trained where they lie.  On a ``mesh``
        give the placed weights and moments (``opt_state``; by default
        moments placed as the weights)."""
        self.cfg, self.tc, self.data = cfg, tc, data
        self.params = (params if params is not None
                       else init_lm(cfg, tc.seed, device=device))
        self.opt_state = (opt_state if opt_state is not None
                          else adamw_init(self.params, tc.optim.moment_dtype))
        self.step_fn = make_train_step(cfg, tc, mesh, pure_dp)
        self.history: List[Dict[str, float]] = []

    def run(self, steps: Optional[int] = None,
            verbose: bool = True) -> Dict[str, float]:
        steps = steps or self.tc.steps
        t0 = time.time()
        last: Dict[str, float] = {}
        for i in range(steps):
            self.params, self.opt_state, metrics = self.step_fn(
                self.params, self.opt_state, next(self.data))
            if i % self.tc.log_every == 0 or i == steps - 1:
                last = {k: float(host_value(v)) for k, v in metrics.items()}
                last["step"] = i
                last["wall_s"] = time.time() - t0
                self.history.append(last)
                if verbose:
                    print(f"step {i:5d} loss {last['loss']:.4f} acc "
                          f"{last.get('acc', 0):.3f} gnorm "
                          f"{last['grad_norm']:.3f} ({last['wall_s']:.1f}s)")
        if self.tc.ckpt_dir:
            save_checkpoint(self.tc.ckpt_dir, self.params, self.opt_state,
                            step=int(self.opt_state["step"]))
        return last
