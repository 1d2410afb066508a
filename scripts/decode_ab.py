"""Decode time of smollm-135m serving for two source trees of the port,
measured in alternation on one card.

The path is ``chip_smoke.py`` phase 13's path B: ``TokenServingEngine``
over random bf16 weights (seed 0), B=8, a 512-token prompt, a
1024-position cache, 64 greedy tokens, ``set_attention_impl("kernel")``.
Each run is a fresh process that imports ``repro_torch`` from its tree's
``src``, warms up once, then prefills and decodes ``--reps`` times on new
engines and reports the median prefill ms and ms per decoded token (host
wall clock, the card synchronised around each phase).

    python3 scripts/decode_ab.py --tree parent=build/parent --tree change=. \\
        --order parent,change,change,parent

Prints one line per run and, last, one JSON object with every run and the
card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

SERVE = dict(B=8, prompt=512, cache_len=1024, tokens=64)


def one(tree: str, reps: int) -> dict:
    sys.path.insert(0, os.path.join(os.path.abspath(tree), "src"))
    import numpy as np
    import torch

    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, synthetic_stream
    from repro_torch.models import layers
    from repro_torch.models.model import init_lm
    from repro_torch.serve.engine import ServeConfig, TokenServingEngine

    dev = torch.device("cuda")
    cfg = get_config("smollm-135m")
    params = init_lm(cfg, seed=0, device=dev)
    batch = next(synthetic_stream(cfg, DataConfig(seq_len=SERVE["prompt"],
                                                  global_batch=SERVE["B"])))
    prompt = {"tokens": batch["tokens"]}
    sc = ServeConfig(batch=SERVE["B"], cache_len=SERVE["cache_len"])
    layers.set_attention_impl("kernel")
    warm = TokenServingEngine(cfg, params, sc, device=dev)
    warm.generate(warm.prefill_prompt(prompt)[:, -1].argmax(-1), 2)
    del warm
    pre, tok, toks = [], [], None
    kernels.reset_launches()
    for _ in range(reps):
        eng = TokenServingEngine(cfg, params, sc, device=dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        first = eng.prefill_prompt(prompt)[:, -1].argmax(-1)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        out = eng.generate(first, SERVE["tokens"])
        t2 = time.perf_counter()
        pre.append((t1 - t0) * 1e3)
        tok.append((t2 - t1) * 1e3 / SERVE["tokens"])
        if toks is not None and not np.array_equal(out, toks):
            raise AssertionError("decoded tokens differ between reps")
        toks = out
    return {"tree": tree, "prefill_ms": float(np.median(pre)),
            "token_ms": float(np.median(tok)), "token_ms_all": tok,
            "launches": kernels.launches(),
            "tokens_head": toks[:, :8].tolist()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", action="append", default=[],
                    help="NAME=DIR, a source tree holding src/repro_torch")
    ap.add_argument("--order", default="",
                    help="comma-separated names, the order of the runs")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--one", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.one:
        print(json.dumps(one(args.one, args.reps)))
        return 0
    trees = dict(t.split("=", 1) for t in args.tree)
    order = args.order.split(",") if args.order else list(trees)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"card: {card}")
    runs = []
    for name in order:
        res = subprocess.run([sys.executable, os.path.abspath(__file__),
                              "--one", trees[name], "--reps",
                              str(args.reps)], capture_output=True,
                             text=True)
        if res.returncode:
            sys.stderr.write(res.stderr)
            raise SystemExit(f"run {name} failed ({res.returncode})")
        r = json.loads(res.stdout.strip().splitlines()[-1])
        r["name"] = name
        runs.append(r)
        print(f"{name}: prefill {r['prefill_ms']:.3f} ms, "
              f"{r['token_ms']:.3f} ms per decoded token (median of "
              f"{args.reps}; all {[round(t, 3) for t in r['token_ms_all']]})"
              f", launches {r['launches']}")
    same = len({json.dumps(r["tokens_head"]) for r in runs}) == 1
    print(json.dumps({"card": card, "same_tokens": same, "runs": runs}))
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
