#!/usr/bin/env python3
"""Plan one dry-run case several times in one process and print each
plan's peak a device (arguments plus temporaries), FLOPs and collective
bytes.  A plan that depends on what ran before it in its process (the
caches DTensor keeps between calls) reads differently after the first.

Plans with the ``repro_torch`` first on ``PYTHONPATH``, so a parent tree
unpacked beside this one can be planned by this script:

    PYTHONPATH=src python3 scripts/plan_repeat.py \\
        jamba-1.5-large-398b prefill_32k single --times 2

The figures are byte and FLOP counts of the plan, not times.
"""

import argparse


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("arch")
    ap.add_argument("shape")
    ap.add_argument("mesh", choices=("single", "multi"))
    ap.add_argument("--times", type=int, default=2)
    args = ap.parse_args(argv)

    import torch
    from repro_torch.launch import dryrun
    print(f"torch {torch.__version__}, repro_torch from "
          f"{dryrun.__file__}", flush=True)
    for i in range(args.times):
        rec = dryrun.run_case(args.arch, args.shape, args.mesh,
                              verbose=False)
        if rec.get("status") != "ok":
            print(f"plan {i}: {rec.get('status')} {rec.get('error', '')}")
            return 1
        rf = rec["roofline"]
        print(f"plan {i} of {args.arch} {args.shape} {args.mesh}: peak "
              f"{(rf['arg_bytes'] + rf['temp_bytes']) / 1e9:.6g} GB, FLOPs "
              f"{rf['flops']:.6g}, collectives "
              f"{rf['collective_bytes'] / 1e9:.6g} GB ({rec['plan_s']} s)",
              flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
