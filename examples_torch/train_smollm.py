"""End-to-end training run through the PyTorch port: SmolLM-135M on the
synthetic pipeline for a few hundred steps, reduced by default.

This is the same ``make_train_step`` the launcher runs on a mesh
(``python -m repro_torch.launch.train``); here it runs on one device,
``--device`` (the card by default).

Run (reduced):
  PYTHONPATH=src python examples_torch/train_smollm.py [--device cpu]
Full 135M for 200 steps (on the card):
  PYTHONPATH=src python examples_torch/train_smollm.py --full --steps 200
"""

import argparse

import torch

import repro_torch.configs as C
from repro_torch.data.pipeline import DataConfig, synthetic_stream
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train.trainer import TrainConfig, Trainer


def main(argv=None):
    """Train; return the trainer's logged rows (``step``, ``loss``, ...)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--full", action="store_true", help="full 135M config")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--device", default="cuda",
                    help="where the model trains (cuda or cpu)")
    args = ap.parse_args(argv)

    cfg = C.get_config("smollm-135m")
    if not args.full:
        cfg = cfg.reduced()
    print(f"arch={cfg.name} params={cfg.param_count() / 1e6:.1f}M "
          f"steps={args.steps} batch={args.batch} seq={args.seq}")

    dc = DataConfig(seq_len=args.seq, global_batch=args.batch, seed=0)
    tc = TrainConfig(steps=args.steps, warmup=max(10, args.steps // 20),
                     log_every=max(1, args.steps // 20),
                     dtype=torch.float32 if not args.full else torch.bfloat16,
                     ckpt_dir=args.ckpt,
                     optim=AdamWConfig(lr=3e-3 if not args.full else 6e-4))
    tr = Trainer(cfg, tc, synthetic_stream(cfg, dc), device=args.device)
    last = tr.run()
    first = tr.history[0]["loss"]
    print(f"\nloss {first:.3f} -> {last['loss']:.3f} "
          f"({'learned' if last['loss'] < first - 0.3 else 'check config'})")
    return tr.history


if __name__ == "__main__":
    main()
