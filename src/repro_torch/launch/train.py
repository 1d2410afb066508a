"""Training launcher: the cluster entry point.

Counterpart of ``repro.launch.train``, with its flags and rules: the mesh
from the ranks there are (the production (16, 16) / (2, 16, 16) meshes at
256 / 512 ranks, else (1, n); ``--mesh DATAxMODEL`` picks another),
``pure_dp`` below 3 B parameters (weights replicated, the batch over every
axis), the parameter and optimiser shardings the dry-run plans with, f32
on one rank and bf16 on more, and the synthetic pipeline.  Ranks come from
``torch.distributed.run`` (``RANK`` / ``WORLD_SIZE`` / ``MASTER_ADDR`` /
``MASTER_PORT``), or one rank without them; NCCL on the card (one rank a
card), gloo with ``--device cpu`` (two ranks cannot share a card: ROADMAP
Queue 3).  A checkpoint is written by
rank 0 in the JAX package's format.

Examples:
  # reduced smoke run on the host's CPU, two ranks
  PYTHONPATH=src python -m torch.distributed.run --nproc-per-node 2 \\
      -m repro_torch.launch.train --arch smollm-135m --reduced \\
      --steps 50 --batch 8 --seq 128 --device cpu
  # full width on one card
  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m \\
      --steps 100 --batch 8 --seq 2048
"""

from __future__ import annotations

import argparse
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch._device import resolve
from repro_torch.configs import ARCHS, get_config
from repro_torch.data.pipeline import DataConfig, synthetic_stream
from repro_torch.distribution.constraints import set_dp_axes
from repro_torch.distribution.sharding import (
    distribute,
    mesh_axes,
    opt_specs,
    param_specs,
)
from repro_torch.launch.mesh import (
    _mesh,
    _world,
    init_ranks,
    make_production_mesh,
)
from repro_torch.models.model import LM, init_lm
from repro_torch.optim.adamw import AdamWConfig, adamw_init
from repro_torch.train.trainer import TrainConfig, Trainer


def make_launch_mesh(device: str = "cuda", shape: Optional[Tuple[int, int]]
                     = None):
    """Best mesh for the ranks there are: (2, 16, 16) at 512 or more,
    (16, 16) at 256 or more, else (1, n) ("data", "model"); ``shape`` =
    (data, model) instead when given."""
    n = _world()
    if shape is not None:
        if shape[0] * shape[1] != n:
            raise ValueError(f"mesh {shape} needs {shape[0] * shape[1]} "
                             f"ranks, not {n}")
        return _mesh(device, shape, ("data", "model"))
    if n >= 512:
        return make_production_mesh(multi_pod=True, device=device)
    if n >= 256:
        return make_production_mesh(multi_pod=False, device=device)
    return _mesh(device, (1, n), ("data", "model"))


def place(lm: LM, opt, mesh, *, fsdp: bool = False, pure_dp: bool = False):
    """The weights and AdamW's moments as DTensors on ``mesh`` with their
    rules' placements (``param_specs`` / ``opt_specs``); every rank passes
    the same full tensors.  ``step`` stays a host scalar."""
    axes = mesh_axes(mesh)
    tree = lm.tree()
    params = LM(lm.cfg, distribute(tree, param_specs(
        axes, tree, fsdp=fsdp, pure_dp=pure_dp), mesh))
    if opt is None:
        return params, None
    moments = {"mu": opt["mu"], "nu": opt["nu"]}
    placed = distribute(moments, opt_specs(axes, moments, fsdp=fsdp,
                                           pure_dp=pure_dp), mesh)
    return params, dict(placed, step=opt["step"])


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, float]:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="smollm-135m", choices=sorted(ARCHS))
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--mesh", default=None,
                    help="DATAxMODEL, e.g. 2x1 (default: from the ranks)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    dev = resolve(args.device)
    own_group = not dist.is_initialized()
    rank, world = init_ranks(dev.type)
    shape = (tuple(int(s) for s in args.mesh.split("x"))
             if args.mesh else None)
    mesh = make_launch_mesh(dev.type, shape)
    pure_dp = cfg.param_count() < 3e9
    set_dp_axes(("pod", "data", "model") if pure_dp else None)
    if rank == 0:
        print(f"arch={cfg.name} params={cfg.param_count() / 1e6:.1f}M "
              f"devices={world} ({dev.type}) mesh={mesh_axes(mesh)} "
              f"pure_dp={pure_dp}")
    tc = TrainConfig(steps=args.steps, warmup=max(5, args.steps // 20),
                     log_every=max(1, args.steps // 20), ckpt_dir=args.ckpt,
                     dtype=torch.float32 if world == 1 else torch.bfloat16,
                     microbatches=args.microbatches,
                     optim=AdamWConfig(lr=args.lr))
    dc = DataConfig(seq_len=args.seq, global_batch=args.batch)
    lm = init_lm(cfg, 0, device=dev)
    params, opt = place(lm, adamw_init(lm), mesh, pure_dp=pure_dp)
    del lm
    trainer = Trainer(cfg, tc, synthetic_stream(cfg, dc), params=params,
                      opt_state=opt, mesh=mesh, pure_dp=pure_dp)
    try:
        last = trainer.run(verbose=rank == 0)
    finally:
        set_dp_axes(None)
        if own_group:
            dist.destroy_process_group()
    if args.ckpt and rank == 0:
        print(f"checkpoint -> {args.ckpt}")
    return last


if __name__ == "__main__":
    main()
