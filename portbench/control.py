"""The readings that a sweep cell's limits are set from, on several seeds in
one process:

* the program: one sweep of the cell's grid through ``run_sweep`` (the
  timed path at the timed size), its sample against the plain reference
  in float32 (the lower readings);
* the control: the reference in bfloat16, the precision below the
  configuration's float32, put in the program's place on the same sample
  (the upper readings).

    python3 portbench/control.py --workload grid-median-b12288 \\
        --seeds 11 12 13 --out control_median.jsonl

Prints one JSON line a seed and side.  ``--device cpu`` and the override
flags run it at a small size on the host.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def readings(workload, seed, device, *, traffic_override=None,
             config_override=None):
    """``{"program": numbers, "control": numbers}`` of one seed."""
    import torch

    from portbench import harness
    from portbench.generators import sweep

    bench, cell, config, traffic, limits = harness.resolve(workload)
    traffic = dict(traffic, **(traffic_override or {}))
    config = dict(config, **(config_override or {}))
    run = harness.Run(bench, cell, config, traffic, limits, seed=seed,
                      seconds=0, trace=False, device=device,
                      t_start=time.perf_counter())
    state = sweep.prepare(run)
    idx = sweep.sample_indices(state.grid, limits, seed)
    want = sweep.reference_answers(run, state.grid, idx, torch.float32,
                                   device)
    res = sweep._sweep(state)
    got = [sweep._answer(res[i]) for i in idx]
    low = sweep.reference_answers(run, state.grid, idx, torch.bfloat16,
                                  device)
    exact = sweep.exact(limits)
    return {"program": sweep.numbers(got, want, exact),
            "control": sweep.numbers(low, want, exact)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--traffic", default=None,
                    help="JSON object of traffic keys to replace")
    ap.add_argument("--config", default=None,
                    help="JSON object of configuration keys to replace")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch
    if args.device == "cuda" and not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    sink = open(args.out, "a", encoding="utf-8") if args.out else None
    try:
        for seed in args.seeds:
            t = time.perf_counter()
            r = readings(args.workload, seed, args.device,
                         traffic_override=json.loads(args.traffic or "{}"),
                         config_override=json.loads(args.config or "{}"))
            for side, nums in r.items():
                line = json.dumps({"workload": args.workload, "seed": seed,
                                   "side": side, **nums,
                                   "seconds": time.perf_counter() - t})
                print(line, flush=True)
                if sink:
                    sink.write(line + "\n")
                    sink.flush()
    finally:
        if sink:
            sink.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
