#!/usr/bin/env python3
"""Hold the port's dry-run plans against the JAX package's, case by case.

Reads the JSONL records of ``python -m repro.launch.dryrun --out JAX`` and
``python -m repro_torch.launch.dryrun --out PORT`` (optionally a second
port sweep, ``--before``, from an earlier tree) and prints one markdown
row an (architecture, input shape, mesh): per device and step, the
collective bytes (GB), the FLOPs and the peak (arguments plus
temporaries, GB) in each, and the port's over JAX's.  A case is flagged
where the port

* moves more than twice JAX's collective bytes and more than 0.05 GB
  above them;
* computes more than 1.5× JAX's FLOPs plus 1e12; above 1.25× plus 1e12
  it is marked, not flagged;
* peaks above twice JAX's plus 1 GB, or above 80 GB (an H100's memory);
* or (with ``--before``) where a column that was within its bound rose
  by more than 5%.

Exits 1 if any case is flagged.  The figures are byte and FLOP counts of
the plans, not times.

    PYTHONPATH=src python -m repro.launch.dryrun --arch all --shape all \\
        --mesh both --out build/dryrun_jax.jsonl
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all \\
        --shape all --mesh both --out build/dryrun_torch.jsonl
    python3 scripts/dryrun_compare.py build/dryrun_jax.jsonl \\
        build/dryrun_torch.jsonl [--before build/dryrun_torch_parent.jsonl]
"""

import argparse
import json
import sys

GB = 1e9
RISE = 1.05                     # a column up by more than 5% has risen
FLOPS_RATIO, FLOPS_AIM, FLOPS_SLACK = 1.5, 1.25, 1e12
PEAK_CAP = 80.0                 # GB a device


def load(path):
    """{(arch, shape, mesh): record}, the last record of a case winning."""
    out = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line.startswith("{"):
                r = json.loads(line)
                out[(r["arch"], r["shape"], r["mesh"])] = r
    return out


def _ok(rec):
    return rec is not None and rec.get("status") == "ok"


def coll(rec):
    return rec["roofline"]["collective_bytes"] if _ok(rec) else None


def flops(rec):
    return rec["roofline"].get("flops") if _ok(rec) else None


def peak(rec):
    if not _ok(rec):
        return None
    r = rec["roofline"]
    return (r["arg_bytes"] + r["temp_bytes"]) / GB


# each column: (its value in a record, whether a value is over the bound
# given JAX's)
BOUNDS = {
    "coll": (coll, lambda j, v: v > 2 * j and v - j > 0.05 * GB),
    "FLOPs": (flops, lambda j, v: v > FLOPS_RATIO * j + FLOPS_SLACK),
    "peak": (peak, lambda j, v: v > 2 * j + 1 or v > PEAK_CAP),
}


def _fmt(x, unit=1.0):
    return "-" if x is None else f"{x / unit:.4g}"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("jax")
    ap.add_argument("port")
    ap.add_argument("--before", default=None,
                    help="an earlier tree's port sweep")
    args = ap.parse_args(argv)
    jax, port = load(args.jax), load(args.port)
    before = load(args.before) if args.before else {}
    head = ["case", "mesh"]
    for col in ("coll GB", "FLOPs", "peak GB"):
        head += [f"{col} JAX"] + (["before"] if before else []) + [
            "port", "port / JAX"]
    head.append("flags")
    print("| " + " | ".join(head) + " |")
    print("|" + "---|" * len(head))
    flagged = 0
    for key in sorted(jax, key=lambda k: (k[0], k[1], k[2] != "single")):
        j, p, b = jax[key], port.get(key), before.get(key)
        row = [f"{key[0]} {key[1]}", key[2]]
        if not _ok(j) or not _ok(p):
            bad = _ok(j)
            flagged += bad
            row += [f"JAX {j.get('status')}, port "
                    f"{p.get('status') if p else 'missing'}"]
            row += [""] * (len(head) - 4) + ["**missing**" if bad else ""]
            print("| " + " | ".join(row) + " |")
            continue
        flags = []
        for col, (get, over) in BOUNDS.items():
            unit = GB if col == "coll" else 1.0
            jv, pv, bv = get(j), get(p), get(b)
            if jv is None or pv is None:
                row += [_fmt(jv, unit)] + (["-"] if before else []) + [
                    _fmt(pv, unit), "-"]
                continue
            if over(jv, pv):
                flags.append(f"**{col} over bound**")
            if bv is not None and not over(jv, bv) and pv > RISE * bv:
                flags.append(f"**{col} rose**")
            if col == "FLOPs" and not over(jv, pv) \
                    and pv > FLOPS_AIM * jv + FLOPS_SLACK:
                flags.append(f"FLOPs over {FLOPS_AIM}×")
            row += [_fmt(jv, unit)] + ([_fmt(bv, unit)] if before else [])
            row += [_fmt(pv, unit), f"{pv / jv:.3g}" if jv else "-"]
        flagged += any(f.startswith("**") for f in flags)
        print("| " + " | ".join(row + [", ".join(flags)]) + " |")
    print(f"\n{flagged} case(s) flagged")
    return 1 if flagged else 0


if __name__ == "__main__":
    sys.exit(main())
