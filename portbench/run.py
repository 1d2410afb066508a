"""Run one cell of ``BENCHMARK.json`` on one NVIDIA H100.

    python3 portbench/run.py --workload grid-median-b12288 --seed 7 \\
        --seconds 20 --trace 0

Prints the result as one JSON object on the last line of standard output
(``--trace 0``: the cell's end-to-end metrics; ``--trace 1``: its
per-layer metrics, the device's busy time and the trace's breakdown), and
each compared number beside its limit as the last lines of standard
error.  Exits non-zero, printing no result, without a CUDA device, when
JAX or the JAX package is loaded once the window has closed, and when the
program is not beside the benchmark (``src/repro_torch``).
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def _environment() -> None:
    """Fixed cache directories inside the checkout; one host thread."""
    build = ROOT / "build"
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton_cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["USE_FLAX"] = "0"
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS"):
        os.environ[var] = "1"
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _environment()

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < 1:
        print("no CUDA device: the benchmark measures the card only",
              file=sys.stderr)
        return 2
    torch.set_num_threads(1)

    from portbench import harness

    try:
        out = harness.execute(args.workload, args.seed, args.seconds,
                              bool(args.trace), t_start=T_START)
    except harness.ForeignImport as e:
        print(f"refusing to report: {e}", file=sys.stderr)
        return 3
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
