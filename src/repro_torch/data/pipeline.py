"""Data pipeline: deterministic synthetic token streams + batch specs.

The synthetic stream is a seeded Markov-ish token generator (cheap, infinite,
reproducible across hosts by shard index) used by the scoring, serving and
training paths and the tests.  It is numpy only, copied from
``repro.data.pipeline``, so a seed gives the same batches bit for bit in
both packages.  ``make_batch_specs`` builds the stand-ins the dry-run
planner (``repro_torch.launch.dryrun``) traces against: tensors on the
``meta`` device, the same keys, shapes and dtypes, no allocation.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator

import numpy as np
import torch

from repro_torch.models.config import InputShape, ModelConfig


@dataclasses.dataclass(frozen=True)
class DataConfig:
    seq_len: int
    global_batch: int
    seed: int = 0
    n_vis: int = 64          # vlm: patch tokens per sample
    enc_ratio: int = 4       # audio: encoder frames = seq_len, decoder = seq/ratio


def dec_len(cfg: ModelConfig, seq_len: int) -> int:
    """Decoder-side length for enc-dec models (audio frames dominate)."""
    return max(128, seq_len // 8) if cfg.enc_dec else seq_len


def synthetic_stream(cfg: ModelConfig, dc: DataConfig, shard: int = 0,
                     n_shards: int = 1) -> Iterator[Dict[str, np.ndarray]]:
    """Infinite stream of host-side batches for this data shard."""
    rng = np.random.default_rng(dc.seed * 9973 + shard)
    B = dc.global_batch // n_shards
    S = dc.seq_len
    Sd = dec_len(cfg, S)
    V = cfg.vocab
    # low-entropy structured stream: tokens follow a noisy linear recurrence,
    # so a real model can actually reduce loss on it
    while True:
        base = rng.integers(0, V, size=(B, 1))
        steps = rng.integers(1, 17, size=(B, Sd + 1))
        toks = (base + np.cumsum(steps, axis=1)) % V
        batch: Dict[str, np.ndarray] = {
            "tokens": toks[:, :Sd].astype(np.int32),
            "targets": toks[:, 1:Sd + 1].astype(np.int32),
        }
        if cfg.family == "vlm":
            nv = min(dc.n_vis, Sd // 2)
            batch["vision_embed"] = rng.normal(0, 0.02, size=(B, nv, cfg.d_model)).astype(np.float32)
            pos = np.broadcast_to(np.arange(Sd)[None], (B, Sd))
            batch["rope_pos"] = np.broadcast_to(pos[None], (3, B, Sd)).astype(np.int32)
        if cfg.enc_dec:
            batch["audio_embed"] = rng.normal(0, 0.02, size=(B, S, cfg.d_model)).astype(np.float32)
        yield batch


def make_batch_specs(cfg: ModelConfig, shape: InputShape,
                     dtype=torch.bfloat16) -> Dict[str, torch.Tensor]:
    """Stand-ins on the ``meta`` device for every model input of this shape
    (no allocation): tokens and targets (train), tokens (prefill), the one
    new token (decode; caches are built separately), with ``vision_embed``
    (B, 64, d) and ``rope_pos`` (3, B, Sd) for the VLM and
    ``audio_embed`` (B, S, d) for encoder-decoder models."""
    B, S = shape.global_batch, shape.seq_len
    Sd = dec_len(cfg, S)

    def sds(dims, dt):
        return torch.empty(dims, dtype=dt, device="meta")

    i32 = torch.int32
    if shape.kind == "decode":
        return {"tokens": sds((B, 1), i32)}
    specs = {"tokens": sds((B, Sd), i32)}
    if shape.kind == "train":
        specs["targets"] = sds((B, Sd), i32)
    if cfg.family == "vlm":
        specs["vision_embed"] = sds((B, 64, cfg.d_model), dtype)
        specs["rope_pos"] = sds((3, B, Sd), i32)
    if cfg.enc_dec:
        specs["audio_embed"] = sds((B, S, cfg.d_model), dtype)
    return specs
