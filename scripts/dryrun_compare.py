#!/usr/bin/env python3
"""Hold the port's dry-run plans against the JAX package's, case by case.

Reads the JSONL records of ``python -m repro.launch.dryrun --out JAX`` and
``python -m repro_torch.launch.dryrun --out PORT`` (optionally a second
port sweep, ``--before``, from an earlier tree) and prints one markdown
row an (architecture, input shape), each mesh side by side: per-device
collective bytes of one step in each (GB), the port's over JAX's, and
the peak a device (arguments plus temporaries, GB).  A case is flagged
where the port moves more than twice JAX's bytes and more than 0.05 GB
above them, or (with ``--before``) where a case
that was within twice JAX's rose by more than 5%.  Exits 1 if any case is
flagged.  The figures are byte counts of the plans, not times.

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


def coll(rec):
    return rec["roofline"]["collective_bytes"] if rec and \
        rec.get("status") == "ok" else None


def peak(rec):
    r = rec["roofline"]
    return (r["arg_bytes"] + r["temp_bytes"]) / GB


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("jax")
    ap.add_argument("port")
    ap.add_argument("--before", default=None,
                    help="an earlier tree's port sweep")
    args = ap.parse_args(argv)
    jax, port = load(args.jax), load(args.port)
    before = load(args.before) if args.before else {}
    meshes = sorted({k[2] for k in jax}, reverse=True)    # single, multi
    head = ["case"]
    for m in meshes:
        head += [f"{m}: JAX GB"] + (["before"] if before else []) + [
            "port", "port / JAX"]
    head += [f"peak {m}: JAX / " + ("before / " if before else "") + "port"
             for m in meshes]
    print("| " + " | ".join(head) + " |")
    print("|" + "---|" * len(head))
    flagged = 0
    for arch, shape in sorted({k[:2] for k in jax}):
        row, peaks = [f"{arch} {shape}"], []
        for m in meshes:
            key = (arch, shape, m)
            j, p, b = jax[key], port.get(key), before.get(key)
            if j.get("status") != "ok" or coll(p) is None:
                row += [f"JAX {j.get('status')}, port "
                        f"{p.get('status') if p else 'missing'}"]
                row += [""] * (3 + bool(before) - 1)
                peaks.append("-")
                flagged += j.get("status") == "ok"
                continue
            jc, pc, bc = coll(j), coll(p), coll(b)
            bad = pc > 2 * jc and pc - jc > 0.05 * GB
            rose = bc is not None and bc <= 2 * jc and pc > 1.05 * bc
            flagged += bad or rose
            row += [f"{jc / GB:.4g}"] + ([f"{bc / GB:.4g}" if bc is not None
                                           else "-"] if before else [])
            row += [f"{pc / GB:.4g}" + (" **over 2×**" if bad else "")
                    + (" **rose**" if rose else ""), f"{pc / jc:.3g}"]
            peaks.append(" / ".join(f"{peak(r):.2f}" for r in (
                (j, b, p) if before else (j, p)) if r is not None))
        print("| " + " | ".join(row + peaks) + " |")
    print(f"\n{flagged} case(s) flagged")
    return 1 if flagged else 0


if __name__ == "__main__":
    sys.exit(main())
