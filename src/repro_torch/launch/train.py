"""Training launcher: train a configuration on one device.

Counterpart of ``repro.launch.train``, with its flags and its dtype rule
(f32 on one device), plus ``--device`` (the card by default).  It trains
on one card: the JAX launcher's host mesh and parameter and optimiser
shardings belong to the model stack's meshes, which the port does not
have yet.

Examples:
  # reduced smoke run on the host's CPU
  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m \\
      --reduced --steps 50 --batch 8 --seq 128 --device cpu
  # full width on the card
  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m \\
      --steps 100 --batch 8 --seq 2048
"""

from __future__ import annotations

import argparse
from typing import Dict, Optional, Sequence

import torch

from repro_torch._device import resolve
from repro_torch.configs import ARCHS, get_config
from repro_torch.data.pipeline import DataConfig, synthetic_stream
from repro_torch.models.model import init_lm
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train.trainer import TrainConfig, Trainer


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
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    dev = resolve(args.device)
    print(f"arch={cfg.name} params={cfg.param_count() / 1e6:.1f}M "
          f"devices=1 ({dev})")
    tc = TrainConfig(steps=args.steps, warmup=max(5, args.steps // 20),
                     log_every=max(1, args.steps // 20), ckpt_dir=args.ckpt,
                     dtype=torch.float32,      # one device: f32, as in JAX
                     microbatches=args.microbatches,
                     optim=AdamWConfig(lr=args.lr))
    dc = DataConfig(seq_len=args.seq, global_batch=args.batch)
    trainer = Trainer(cfg, tc, synthetic_stream(cfg, dc),
                      params=init_lm(cfg, 0, device=dev))
    last = trainer.run()
    if args.ckpt:
        print(f"checkpoint -> {args.ckpt}")
    return last


if __name__ == "__main__":
    main()
