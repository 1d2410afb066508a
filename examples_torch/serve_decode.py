"""Batched serving demo through the PyTorch port: prefill a prompt batch,
then greedy-decode with the per-architecture cache (KV / MLA latent / SSM
state / hybrid).

Runs the cache families side by side (reduced configurations):
  smollm-135m   dense GQA      -> KV cache
  rwkv6-7b      attention-free -> O(1) recurrent state
  jamba-...     hybrid         -> mamba state + attention KV, MoE routing
  deepseek-...  MLA            -> latent cache, MoE routing
  whisper-...   encoder-decoder -> self and cross KV

Run:  PYTHONPATH=src python examples_torch/serve_decode.py [--device cpu]
"""

import argparse
import time

import torch

import repro_torch.configs as C
from repro_torch.models import model as M
from repro_torch.serve import ServeConfig, TokenServingEngine


def _leaves(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def demo(arch: str, n_new: int = 16, device="cuda"):
    """Prefill and decode one reduced configuration; returns ``(arch,
    prefill ms, decode ms, cache leaves, cache MB, tokens (B, n_new))``."""
    cfg = C.get_config(arch).reduced()
    lm = M.init_lm(cfg, 0, device=device)
    B, S = 4, 24
    sc = ServeConfig(batch=B, cache_len=S + n_new + 1, dtype=torch.float32,
                     enc_len=32 if cfg.enc_dec else 0)
    eng = TokenServingEngine(cfg, lm, sc, device=device)
    gen = torch.Generator().manual_seed(1)
    batch = {"tokens": torch.randint(0, cfg.vocab, (B, S), generator=gen,
                                     dtype=torch.int32)}
    if cfg.family == "vlm":
        batch["vision_embed"] = torch.randn(B, 8, cfg.d_model,
                                            generator=gen) * 0.02
        pos = torch.arange(S, dtype=torch.int32)[None].expand(B, S)
        batch["rope_pos"] = pos[None].expand(3, B, S).contiguous()
    if cfg.enc_dec:
        batch["audio_embed"] = torch.randn(B, 32, cfg.d_model,
                                           generator=gen) * 0.02
    _sync(device)
    t0 = time.perf_counter()
    logits = eng.prefill_prompt(batch)
    _sync(device)
    t1 = time.perf_counter()
    toks = eng.generate(logits[:, -1].argmax(-1), n_new)
    t2 = time.perf_counter()
    leaves = list(_leaves(eng.caches))
    cache_mb = sum(x.numel() * x.element_size() for x in leaves) / 1e6
    print(f"{arch:24s} prefill {1e3 * (t1 - t0):7.1f}ms  "
          f"{n_new} tokens {1e3 * (t2 - t1):7.1f}ms  "
          f"cache: {len(leaves)} leaves {cache_mb:.2f}MB")
    print(f"{'':24s} sample: {toks[0][:8].tolist()}")
    return arch, 1e3 * (t1 - t0), 1e3 * (t2 - t1), len(leaves), cache_mb, toks


def main(argv=None):
    """Print the table; return one :func:`demo` row per configuration."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="where the models run (cuda or cpu)")
    args = ap.parse_args(argv)
    print(f"{'arch':24s} {'prefill':>15s} {'decode':>18s}  cache")
    return [demo(arch, device=args.device)
            for arch in ("smollm-135m", "rwkv6-7b", "jamba-1.5-large-398b",
                         "deepseek-v2-236b", "whisper-medium")]


if __name__ == "__main__":
    main()
