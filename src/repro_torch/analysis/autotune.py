"""Launch-plan tuner for the port's protocol kernels (counterpart of
``repro.analysis.autotune``).

The JAX package tunes the Pallas Pegasos stage's block shape per shape
bucket and keeps the winners in a committed cache.  Here the tuned
decisions are the launch plans of four CUDA kernels that no plan can make
give another bit of output:

* ``pegasos_stage`` (``csrc/pegasos_stage.cu``): instances (warps) a
  block, ``{"warps": 1|2|4|8}``, own plan 4.  A warp runs an instance, so
  every instance keeps its sum order (``kernels.pegasos.block_sum``); the
  counterpart of JAX's ``block_b``.
* ``median_extremes`` (``csrc/median_extremes.cu``): warps a row block,
  ``{"team": 1|2|4|8}``, own plan ``team_for``.  Ties go to the smaller
  index whatever the team.
* ``maxmarg_turn_scan`` (``csrc/maxmarg_turn.cu``): warps a segment,
  ``{"team": 1|2|4|8}``, own plan ``plan``.  Its outputs are integers.
* ``threshold_ranges`` (``csrc/threshold_ranges.cu``): directions a
  thread and instances a block, ``{"per_thread": 1|4, "per_block":
  1|2|3}``; the rest of the split is ``ranges_occupancy``'s.  The warps a
  row group and the rows a chunk stay the kernel's own: they set the order
  in which rows are folded, and so which of a +0 and a -0 projection that
  tie for an extreme comes out.

Not tuned: the attention, WKV and selective-scan kernels (rows 9-11),
whose tiles fix the order of a floating-point sum that their plain
versions spell out; and the cut scan and the set-of-uncertainty scan
(``median_cut.cu`` ``nt`` / ``splits``, ``uncertain_mask.cu`` ``parts``),
exact under any plan, but whose plans are tied to their shared memory
(the next kernels for this tuner).

Lookup is pure and never raises on a bad cache:

1. the launch shape is bucketed as JAX buckets it (next power of two per
   axis, floors ``B >= 1``, ``N >= 8``, ``d >= 2``; the ranges scan's
   directions ``m >= 1`` too).  Each kernel's ``B`` is what its plan
   spreads over the card: instances for the stage and the ranges scan,
   row blocks (instances × nodes) for the extremes scan, segments
   (instances × (nodes + 1)) for the turn scan; ``N`` is the rows of one;
2. the committed cache ``src/repro_torch/kernels/tuning_cache.json`` is
   read with the key ``"{card name}|{kernel}|B{bB}_N{bN}_d{bd}"`` (plus
   ``_m{bm}`` for the ranges scan);
3. a miss returns ``None``, and ``None`` is the kernel's own plan, as
   before there was a cache: an unknown card, an untuned bucket, a missing
   or malformed file or entry, or an entry that the kernel could not
   launch at the exact shape (:func:`valid_plan`).

The search half (``python -m repro_torch.analysis.autotune``, on the card
only) draws inputs from a seed at each bucket's main-path shape, checks
each candidate's outputs bit for bit against the own plan's, times the
candidates with :func:`repro_torch.analysis.bounds.graph_ms` interleaved
round-robin and keeps each one's fastest round (as ``benchmarks/
_timing.py`` does).  A plan is recorded only where it beats the own plan
by more than the own plan's spread between rounds and by at least
``MIN_GAIN`` (1%), with its device time, the own plan's and the call's
bound (:func:`repro_torch.analysis.bounds.bound_ms`, which says how far
either is from the card's limit); elsewhere the bucket keeps no entry.  ``--write`` writes the searched
buckets' verdicts into the committed cache.
"""

from __future__ import annotations

import argparse
import functools
import json
import os
from typing import Dict, Optional, Tuple

CACHE_PATH = os.path.join(os.path.dirname(__file__), os.pardir, "kernels",
                          "tuning_cache.json")

def _bucket_pow2(x: int, floor: int) -> int:
    x = max(int(x), floor)
    return 1 << (x - 1).bit_length()


def bucket(B: int, N: int, d: int) -> Tuple[int, int, int]:
    """Shape bucket for cache keying: next pow-2 with per-axis floors."""
    return _bucket_pow2(B, 1), _bucket_pow2(N, 8), _bucket_pow2(d, 2)


def cache_key(device_name: str, kernel: str, B: int, N: int, d: int,
              m: Optional[int] = None) -> str:
    bB, bN, bd = bucket(B, N, d)
    key = f"{device_name}|{kernel}|B{bB}_N{bN}_d{bd}"
    return key if m is None else f"{key}_m{_bucket_pow2(m, 1)}"


@functools.lru_cache(maxsize=8)
def _load_cache(path: str) -> Dict[str, dict]:
    try:
        with open(path) as fh:
            data = json.load(fh)
    except (OSError, ValueError):
        return {}
    entries = data.get("entries") if isinstance(data, dict) else None
    return entries if isinstance(entries, dict) else {}


def _ints(plan, keys) -> Optional[dict]:
    if not isinstance(plan, dict) or set(plan) != set(keys):
        return None
    if not all(type(plan[k]) is int for k in keys):
        return None
    return dict(plan)


def valid_plan(kernel: str, plan, B: int, N: int, d: int,
               m: Optional[int] = None) -> Optional[dict]:
    """``plan`` as a dict if the kernel can launch it at this exact shape,
    else ``None``.  The checks are the launch wrappers' own pure functions
    (``kernels.pegasos.stage_plan_ok``, ``kernels.support_margin.
    ranges_plan_ok`` and its ``TEAMS``), which hold the kernels' limits."""
    from repro_torch.kernels import pegasos, support_margin
    if kernel in ("median_extremes", "maxmarg_turn_scan"):
        plan = _ints(plan, ("team",))
        return plan if plan and plan["team"] in support_margin.TEAMS \
            else None
    if kernel == "pegasos_stage":
        plan = _ints(plan, ("warps",))
        return plan if plan and pegasos.stage_plan_ok(d, plan["warps"]) \
            else None
    if kernel == "threshold_ranges":
        plan = _ints(plan, ("per_thread", "per_block"))
        return plan if plan and support_margin.ranges_plan_ok(
            N, d, plan["per_thread"], plan["per_block"]) else None
    return None


def lookup_plan(kernel: str, device_name: str, B: int, N: int, d: int,
                m: Optional[int] = None, *,
                path: str = CACHE_PATH) -> Optional[dict]:
    """The cached launch plan of ``kernel`` on the card ``device_name`` at
    this shape, or ``None`` (the kernel's own plan) on a miss."""
    entry = _load_cache(os.path.abspath(path)).get(
        cache_key(device_name, kernel, B, N, d, m))
    if not isinstance(entry, dict):
        return None
    return valid_plan(kernel, entry.get("plan"), B, N, d, m)


@functools.lru_cache(maxsize=16)
def _device_name(index: int) -> str:
    import torch
    return torch.cuda.get_device_name(index)


@functools.lru_cache(maxsize=4096)
def _plan_at(kernel: str, index: int, B: int, N: int, d: int,
             m: Optional[int]) -> Optional[dict]:
    return lookup_plan(kernel, _device_name(index), B, N, d, m)


def plan_for(kernel: str, device, B: int, N: int, d: int,
             m: Optional[int] = None) -> Optional[dict]:
    """:func:`lookup_plan` for the CUDA ``device`` (a ``torch.device``;
    its card's name read once) from the committed cache: what a launch
    wrapper asks when it is given no plan."""
    import torch
    index = torch.cuda.current_device() if device.index is None \
        else device.index
    return _plan_at(kernel, index, B, N, d, m)


# ----------------------------------------------------------------------
# Search half: on the card only; imports the kernels lazily.
# ----------------------------------------------------------------------

# the main paths' buckets: (kernel, label, exact shape)
#   the MEDIAN sweep (B=3072, k=2, n=1000, transcript width 8) and a
#   4-shard sub-batch of it; MAXMARG's three buckets (k2_d2 B=1152,
#   k4_d2 B=128, k2_d16 B=64; fit sets of own rows and 8 transcript
#   rows) and a 4-shard sub-batch of the first; the SOU state (B=3072,
#   m=1024 directions, 392 transcript rows)
MAIN_PATH = (
    ("median_extremes", "MEDIAN B=3072", dict(B=3072, k=2, n=1000, W=8)),
    ("median_extremes", "MEDIAN, 4 shards", dict(B=768, k=2, n=1000, W=8)),
    ("maxmarg_turn_scan", "MAXMARG k2_d2",
     dict(B=1152, k=2, n=1000, N=1008, d=2)),
    ("maxmarg_turn_scan", "MAXMARG k4_d2",
     dict(B=128, k=4, n=100, N=108, d=2)),
    ("maxmarg_turn_scan", "MAXMARG k2_d16",
     dict(B=64, k=2, n=200, N=208, d=16)),
    ("maxmarg_turn_scan", "MAXMARG k2_d2, 4 shards",
     dict(B=288, k=2, n=1000, N=1008, d=2)),
    ("pegasos_stage", "MAXMARG k2_d2", dict(B=1152, N=1008, d=2)),
    ("pegasos_stage", "MAXMARG k4_d2", dict(B=128, N=108, d=2)),
    ("pegasos_stage", "MAXMARG k2_d16", dict(B=64, N=208, d=16)),
    ("pegasos_stage", "MAXMARG k2_d2, 4 shards", dict(B=288, N=1008, d=2)),
    ("threshold_ranges", "SOU state", dict(B=3072, m=1024, n=392, d=2)),
)
STAGE_STEPS = 2000           # the MAXMARG solver's steps a stage
ROUNDS = 5                   # timing rounds of each candidate, interleaved
# the least gain a cached plan must show over the own plan: a kernel's
# device time moves by up to 0.8% between two calls on one H100 80GB HBM3
# at 700 W (the Pegasos stage's own plan at k2_d2, 1.3329 then 1.3436
# ms), so a smaller win says nothing about the next call
MIN_GAIN = 0.01


def plan_shape(kernel: str, s: dict) -> Tuple[int, ...]:
    """(B, N, d[, m]) of a main-path shape, as the kernel's plan sees it."""
    if kernel == "median_extremes":
        return s["B"] * s["k"], s["n"] + s["W"], 2
    if kernel == "maxmarg_turn_scan":
        return s["B"] * (s["k"] + 1), max(s["N"], s["n"]), s["d"]
    if kernel == "pegasos_stage":
        return s["B"], s["N"], s["d"]
    return s["B"], s["n"], s["d"], s["m"]


def inputs(kernel: str, s: dict, device, seed: int = 0):
    """``(call, plain, work)``: a function ``plan -> outputs`` launching
    the kernel at main-path shape ``s`` on inputs drawn from ``seed``
    (labels ±1 with a tail of padding rows), its plain version on the same
    inputs (no argument), and the call's
    :class:`~repro_torch.analysis.bounds.Work`."""
    import torch

    from repro_torch import kernels
    from repro_torch.analysis import bounds
    from repro_torch.core.geometry import direction_grid

    g = torch.Generator().manual_seed(seed)

    def pts(*shape):
        return torch.randn(*shape, generator=g).to(device)

    def labels(*shape, pad=0.1):
        y = torch.where(torch.rand(*shape, generator=g) < 0.5, 1, -1)
        y[..., int(shape[-1] * (1 - pad)):] = 0
        return y.to(torch.int32).to(device)

    if kernel == "median_extremes":
        B, k, n, W = s["B"], s["k"], s["n"], s["W"]
        args = (pts(B, 2), pts(B, k, n, 2), labels(B, k, n, pad=0.0),
                pts(B, k, 4 * W, 2), labels(B, k, 4 * W), W)
        return ((lambda plan: kernels.median_extremes_segments(
                    *args, plan=plan)),
                (lambda: kernels.median_extremes_segments_plain(*args)),
                bounds.extremes_work(*args))
    if kernel == "maxmarg_turn_scan":
        B, k, n, N, d = s["B"], s["k"], s["n"], s["N"], s["d"]
        args = (pts(B, d), pts(B), pts(B, N, d), labels(B, N),
                pts(B, k, n, d), labels(B, k, n, pad=0.0))
        return ((lambda plan: kernels.maxmarg_turn_scan(*args, plan=plan)),
                (lambda: kernels.maxmarg_turn_scan_plain(*args)),
                bounds.turn_work(*args))
    if kernel == "pegasos_stage":
        B, N, d = s["B"], s["N"], s["d"]
        y = labels(B, N).float()
        args = (pts(B, N, d), y, (y != 0).sum(1).float().clamp_min(1),
                torch.zeros(B, d, device=device),
                torch.zeros(B, device=device),
                torch.full((B,), 1e-3, device=device),
                torch.zeros(B, dtype=torch.bool, device=device),
                torch.zeros(B, d, device=device),
                torch.zeros(B, device=device))
        return ((lambda plan: kernels.pegasos_stage(
                    *args, nsteps=STAGE_STEPS, plan=plan)),
                (lambda: kernels.pegasos_stage_plain(*args,
                                                     nsteps=STAGE_STEPS)),
                bounds.pegasos_work(*args, nsteps=STAGE_STEPS))
    B, m, n, d = s["B"], s["m"], s["n"], s["d"]
    args = (direction_grid(m, device=device) if d == 2 else pts(m, d),
            pts(B, n, d), labels(B, n))
    return ((lambda plan: kernels.threshold_ranges(*args, plan=plan)),
            (lambda: kernels.threshold_ranges_plain(*args)),
            bounds.ranges_work(*args))


def candidates(kernel: str, B: int, N: int, d: int,
               m: Optional[int] = None):
    """Every plan :func:`valid_plan` lets the kernel launch at this shape."""
    from repro_torch.kernels import pegasos, support_margin
    if kernel == "threshold_ranges":
        raw = [{"per_thread": pt, "per_block": pb}
               for pt in (1, 4) for pb in (1, 2, 3)]
    elif kernel == "pegasos_stage":
        raw = [{"warps": w} for w in pegasos.WARPS]
    else:
        raw = [{"team": t} for t in support_margin.TEAMS]
    return [p for p in raw if valid_plan(kernel, p, B, N, d, m)]


def own_plan(kernel: str, s: dict) -> dict:
    """The plan the kernel takes by itself at main-path shape ``s`` (on
    the current card), in the cache's terms."""
    from repro_torch.kernels import support_margin
    if kernel == "pegasos_stage":
        return {"warps": 4}
    if kernel == "median_extremes":
        return {"team": support_margin.extremes_occupancy(
            s["B"] * s["k"])[0]}
    if kernel == "maxmarg_turn_scan":
        return {"team": support_margin.turn_occupancy(
            s["B"], s["N"], s["k"], s["n"], s["d"])[0]}
    split = support_margin.ranges_occupancy(s["B"], s["m"], s["n"], s["d"])
    return {"per_thread": split.per_thread, "per_block": split.per_block}


def same_bits(a, b) -> bool:
    """Whether two outputs (tensors or tuples of them) are equal bit for
    bit, signs of zero included."""
    import torch
    if isinstance(a, torch.Tensor):
        return bool(torch.equal(a, b)) and (
            not a.is_floating_point()
            or bool(torch.equal(torch.signbit(a), torch.signbit(b))))
    return len(a) == len(b) and all(same_bits(x, y) for x, y in zip(a, b))


def search_bucket(kernel: str, s: dict, *, card: str,
                  seed: int = 0) -> dict:
    """Tune one bucket on the current card: every valid plan's outputs bit
    for bit the own plan's, then each timed (CUDA-graph device time),
    interleaved round-robin over ``ROUNDS`` rounds, its fastest round
    kept.  The fastest plan wins only if it beats the own plan's fastest
    round by more than the own plan's spread over its rounds (slowest
    less fastest) and by at least ``MIN_GAIN`` of its time; else the own
    plan stays and the bucket gets no entry.
    Returns ``{"key", "entry", "won"}`` (not yet merged): ``entry`` the
    fastest plan's record, ``won`` whether it goes into the cache."""
    import torch

    from repro_torch.analysis import bounds

    dev = torch.device("cuda", torch.cuda.current_device())
    shape = plan_shape(kernel, s)
    call, _, work = inputs(kernel, s, dev, seed)
    own = own_plan(kernel, s)
    want = call(own)
    cands = candidates(kernel, *shape)
    for plan in cands:
        if not same_bits(call(plan), want):
            raise AssertionError(f"{kernel} at {s}: plan {plan} changes "
                                 f"the outputs of the own plan {own}")
    times = {i: [] for i in range(len(cands))}
    for _ in range(ROUNDS):
        for i, plan in enumerate(cands):
            times[i].append(bounds.graph_ms(lambda p=plan: call(p), n=20,
                                            reps=3))
    best = min(times, key=lambda i: min(times[i]))
    own_t = times[cands.index(own)]
    spread = max(own_t) - min(own_t)
    bound, by = bounds.bound_ms(work)
    entry = {"plan": cands[best], "us": min(times[best]) * 1e3,
             "own_plan": own, "own_us": min(own_t) * 1e3,
             "own_spread_us": spread * 1e3, "bound_us": bound * 1e3,
             "bound_by": by, "shape": list(shape), "card": card}
    won = min(times[best]) < min(min(own_t) - spread,
                             (1 - MIN_GAIN) * min(own_t))
    return {"key": cache_key(torch.cuda.get_device_name(dev), kernel,
                             *shape),
            "entry": entry, "won": won}


def _card() -> str:
    import subprocess
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    labels = sorted({label for _, label, _ in MAIN_PATH})
    ap.add_argument("--shapes", nargs="+", default=labels, choices=labels,
                    help="main-path shapes to tune (every kernel there)")
    ap.add_argument("--write", action="store_true",
                    help="write the searched buckets' winners (and drop "
                         "their entries where the own plan stays) into "
                         "the committed cache")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        raise RuntimeError("the tuner's search times kernels on a CUDA "
                           "card; none is available")
    from repro_torch.kernels import _build
    _build.build_all()
    card = _card()
    entries: Dict[str, dict] = dict(_load_cache(os.path.abspath(CACHE_PATH)))
    for kernel, label, s in MAIN_PATH:
        if label not in args.shapes:
            continue
        found = search_bucket(kernel, s, card=card)
        e = found["entry"]
        verdict = "cached" if found["won"] else "own plan kept, no entry"
        print(f"{kernel} at {label} {tuple(e['shape'])}: fastest "
              f"{e['plan']} {e['us']:.2f} us, own {e['own_plan']} "
              f"{e['own_us']:.2f} us (spread {e['own_spread_us']:.2f} us), "
              f"bound {e['bound_us']:.3f} us ({e['bound_by']}): {verdict}; "
              f"{card}")
        if found["won"]:
            entries[found["key"]] = e
        else:
            entries.pop(found["key"], None)
    if args.write:
        payload = {"format": 1, "entries": dict(sorted(entries.items()))}
        with open(CACHE_PATH, "w") as fh:
            json.dump(payload, fh, indent=2, sort_keys=True)
            fh.write("\n")
        _load_cache.cache_clear()
        _plan_at.cache_clear()
        print(f"wrote {os.path.normpath(CACHE_PATH)} ({len(entries)} "
              f"entries)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
