#!/usr/bin/env python3
"""The per-device products of one of the JAX package's dry-run cases, as
GSPMD laid them out: compile the case on forced host devices and print
each ``dot`` of the compiled (partitioned) HLO with its per-device operand
and result shapes, its FLOPs times its loops' trip counts, and its
``op_name``, read through ``repro.analysis.hlo_cost``.  Nothing of the JAX
package is changed.  A per-device shape beside the whole one says which
dim GSPMD split: e.g. a score product ``f32[2,32768,128] x
f32[2,128,5120]`` of qwen2.5-14b's prefill on (16, 16) is 2 rows × 32768
keys × 128 head width against 5 heads × 1024 query rows: one key head's
whole group a device, each group on two devices.

    PYTHONPATH=src JAX_PLATFORMS=cpu python3 scripts/jax_dot_layouts.py \\
        qwen2.5-14b prefill_32k --layers 1 [--multi]

``--layers`` cuts the depth (the layout of a layer does not depend on
it); the policy is the full configuration's (``case_policy``).  The
figures are FLOP counts of the plan, not times.
"""

import argparse
import dataclasses
import os
import re
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("arch")
    ap.add_argument("shape")
    ap.add_argument("--layers", type=int, default=None)
    ap.add_argument("--multi", action="store_true",
                    help="the (2, 16, 16) mesh of 512 devices")
    args = ap.parse_args(argv)
    from repro.launch import dryrun as JD      # forces 512 host devices
    if not args.multi:
        os.environ["XLA_FLAGS"] = ("--xla_force_host_platform_device_"
                                   "count=256")
    import jax
    from repro.analysis import hlo_cost as H
    from repro.configs import get_config
    from repro.launch.mesh import make_production_mesh
    from repro.models.config import INPUT_SHAPES

    full = get_config(args.arch)
    cfg = full if args.layers is None else dataclasses.replace(
        full, n_layers=args.layers)
    shape = INPUT_SHAPES[args.shape]
    pol = JD.case_policy(full, shape)
    mesh = make_production_mesh(multi_pod=args.multi)
    with jax.set_mesh(mesh):
        low = JD.lower_case(cfg, shape, mesh, pol)
    model = H.HloCostModel(low.compile().as_text())

    trips = {}

    def walk(comp, m):
        if trips.get(comp, 0) >= m:
            return
        trips[comp] = m
        for op in model.comps.get(comp, []):
            if op.kind == "while":
                t = H._TRIP_RE.search(op.rest)
                n = int(t.group(1)) if t else 1
                for ref in (H._BODY_RE.search(op.rest),
                            H._COND_RE.search(op.rest)):
                    if ref:
                        walk(ref.group(1), m * n)
            else:
                for c in H._CALLS_RE.finditer(op.rest):
                    walk(c.group(1), m)

    walk(model.entry, 1)
    rows, total = [], 0.0
    for comp, ops in model.comps.items():
        syms = model.symtabs[comp]
        for op in ops:
            if op.kind not in ("dot", "convolution"):
                continue
            flops = H._dot_flops(op, syms) * trips.get(comp, 0)
            total += flops
            meta = H._META_RE.search(op.rest)
            name = re.sub(r"jit\([^)]*\)/", "", meta.group(1)) if meta \
                else ""
            shapes = " x ".join(syms.get(o, "?").split("{")[0]
                                for o in op.operands[:2])
            rows.append((flops, trips.get(comp, 0), shapes,
                         op.type_str.split("{")[0], name[-90:]))
    print(f"{args.arch} {args.shape} {'multi' if args.multi else 'single'}"
          f" ({cfg.n_layers} layers): {total:.4e} dot FLOPs a device")
    for flops, n, shapes, out, name in sorted(rows, reverse=True):
        print(f"{flops:.3e} x{n:<5g} {shapes} -> {out}  {name}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
