"""Token-decode engine (NOT the protocol service).

Counterpart of ``repro.serve.engine``: a ``serve_step`` (one token, batched
requests) plus a minimal greedy host engine over ``repro_torch.models``.
It has nothing to do with serving the paper's classifier protocols: that
is ``ProtocolService`` (:mod:`repro_torch.serve.service`).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict

import numpy as np
import torch

from repro_torch._device import resolve
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import (
    RunFlags,
    cast_params,
    decode_step,
    make_caches,
    prefill,
)


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    batch: int
    cache_len: int
    dtype: Any = torch.bfloat16
    flags: RunFlags = RunFlags()
    enc_len: int = 0
    temperature: float = 0.0  # greedy


def make_serve_step(cfg: ModelConfig, sc: ServeConfig) -> Callable:
    """(params, caches, tokens (B,1), pos) -> (logits, caches), under
    ``torch.inference_mode``."""

    @torch.inference_mode()
    def serve_step(params, caches, tokens, pos):
        return decode_step(params, cfg, caches, tokens, pos, sc.flags,
                           dtype=sc.dtype)

    return serve_step


class TokenServingEngine:
    """Minimal batched greedy decoder over the functional model API.

    Runs on ``device`` (the card unless ``device="cpu"``).  The weights are
    cast to ``sc.dtype`` and moved there once, at construction; the caches
    (attention keys and values, MLA's latents, the SSM mixers' states) are
    preallocated per layer and written in place by every prefill and decode
    step (the JAX package's engine returns new arrays and donates the old).
    ``generate`` keeps the decoded tokens on the device and reads them
    back once, at the end.  Serving runs under ``torch.inference_mode``,
    so weights that require a gradient (a model in training) build no
    autograd graph and leave none in the caches.
    """

    def __init__(self, cfg: ModelConfig, params, sc: ServeConfig,
                 device="cuda"):
        self.device = resolve(device)
        self.cfg, self.sc = cfg, sc
        with torch.no_grad():
            self.params = cast_params(params, sc.dtype, device=self.device)
        self.caches = make_caches(cfg, sc.batch, sc.cache_len, sc.dtype,
                                  enc_len=sc.enc_len, device=self.device)
        self.step = make_serve_step(cfg, sc)
        self.pos = 0

    def prefill_prompt(self, batch: Dict[str, Any]) -> torch.Tensor:
        """Prefill ``batch`` (tokens [, vision_embed, rope_pos,
        audio_embed]); decoding continues at position ``S``, where
        ``sc.flags.mla_absorb`` selects MLA's latent-space decode."""
        with torch.inference_mode():
            logits, self.caches = prefill(self.params, self.cfg, batch,
                                          self.caches, self.sc.flags,
                                          dtype=self.sc.dtype)
        self.pos = batch["tokens"].shape[1]
        return logits

    def generate(self, first_token, n_tokens: int) -> np.ndarray:
        """Greedy-decode ``n_tokens`` for every request in the batch."""
        tok = torch.as_tensor(first_token, device=self.device).reshape(
            self.sc.batch, 1).to(torch.int32)
        out = []
        for _ in range(n_tokens):
            logits, self.caches = self.step(self.params, self.caches, tok,
                                            self.pos)
            tok = logits[:, -1, :].argmax(-1).to(torch.int32).reshape(-1, 1)
            out.append(tok)
            self.pos += 1
        return torch.cat(out, dim=1).cpu().numpy()


# Compatibility alias, as in the JAX package.
ServingEngine = TokenServingEngine
