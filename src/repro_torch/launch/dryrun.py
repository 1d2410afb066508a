"""Dry-run planner: trace every (arch × input-shape × mesh) on a fake process
group, with nothing allocated and no card.

Counterpart of ``repro.launch.dryrun``.  Where the JAX package lowers and
compiles against 512 host placeholders, this builds a ``"fake"`` process
group of 256 (``--mesh single``: (16, 16) ``("data", "model")``) or 512
(``multi``: (2, 16, 16) ``("pod", "data", "model")``) ranks, plays rank 0,
and for every case:

  1. builds the weights, AdamW's moments, the batch (``make_batch_specs``)
     and the caches as fake DTensors placed by the sharding rules,
  2. runs one train step (train_4k), ``prefill`` (prefill_32k) or
     ``decode_step`` (one token against seq_len caches) under the case
     policy's flags, with :class:`repro_torch.analysis.roofline.PlanMode`
     counting each local operation,
  3. reports the roofline terms, the per-device argument bytes of the plan
     and the peak of the step's temporaries, and
  4. appends a JSON record (``--out``) and ends with a summary line.

The fake group is torn down after each case.  Several cases are planned
at once, one process a core.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all \\
      --shape all --mesh both --out build/dryrun.jsonl
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.analysis.roofline import (
    PlanMode,
    analyze_plan,
    model_flops_estimate,
)
from repro_torch.configs import ARCHS, get_config
from repro_torch.data.pipeline import dec_len, make_batch_specs
from repro_torch.distribution import constraints
from repro_torch.distribution.sharding import (
    batch_specs,
    cache_specs,
    distribute,
    local_bytes,
    mesh_axes,
    opt_specs,
    param_specs,
)
from repro_torch.models.config import INPUT_SHAPES, InputShape, ModelConfig
from repro_torch.models.model import (
    LM,
    RunFlags,
    decode_step,
    init_lm,
    make_caches,
    prefill,
)
from repro_torch.optim.adamw import AdamWConfig, adamw_init, adamw_update
from repro_torch.train.trainer import (
    TrainConfig,
    _split_micro,
    make_train_step,
)


@dataclasses.dataclass
class CasePolicy:
    """Execution policy for one (arch, shape): what the launcher would set."""
    skip: Optional[str] = None
    window: Optional[int] = None
    cache_len: int = 0
    enc_len: int = 0
    microbatches: int = 1
    param_dtype: Any = torch.float32
    moment_dtype: str = "f32"
    fsdp: bool = False
    pure_dp: bool = False
    mla_absorb: bool = False
    remat: bool = True
    block_q: int = 1024
    loss_chunk: int = 512


def case_policy(cfg: ModelConfig, shape: InputShape) -> CasePolicy:
    pol = CasePolicy()
    n = cfg.param_count()
    pol.fsdp = n > 20e9
    # small models: tensor parallelism replicates whole mixers when head
    # counts don't divide the model axis — run them pure data-parallel.
    # Train shapes: the global batch divides the full mesh, so pure-DP wins
    # for everything under ~3B.  Serving shapes keep TP unless the model is
    # tiny (<0.5B); decode always keeps TP: even when heads replicate, TP
    # shards the KV cache head_dim.
    if shape.kind == "train":
        pol.pure_dp = n < 3e9
    elif shape.kind == "prefill":
        pol.pure_dp = n < 0.5e9
    else:
        pol.pure_dp = False
    pol.param_dtype = (torch.float32 if (shape.kind == "train" and n <= 20e9)
                       else torch.bfloat16)
    pol.moment_dtype = "bf16" if n > 20e9 else "f32"
    pol.microbatches = 8 if n > 50e9 else (4 if n > 3e9 else 1)
    if cfg.enc_dec:
        pol.enc_len = shape.seq_len if shape.kind != "decode" else 1500
    if shape.kind == "decode":
        pol.cache_len = shape.seq_len
        if shape.name == "long_500k":
            if cfg.enc_dec:
                pol.skip = ("enc-dec full-attention decoder: 500k-token decode is "
                            "out of family scope (DESIGN.md §Arch-applicability)")
            elif cfg.sliding_window and not cfg.has_state_mixer and cfg.mla is None:
                # dense/vlm/standard-MoE attention: sliding-window variant
                pol.window = cfg.sliding_window
                pol.cache_len = cfg.sliding_window
            # SSM/hybrid run natively; MLA runs on its compressed latent cache
    if shape.kind != "train":
        pol.remat = False
    pol.loss_chunk = min(512, dec_len(cfg, shape.seq_len))
    return pol


def _fake_like(specs: Dict[str, torch.Tensor], device) -> Dict[str, Any]:
    """Fake tensors (zeros under the planning mode) of the stand-ins'
    shapes and dtypes on ``device``."""
    return {k: torch.zeros(v.shape, dtype=v.dtype, device=device)
            for k, v in specs.items()}


def plan_case(cfg: ModelConfig, shape: InputShape, mesh,
              pol: CasePolicy, mode: PlanMode,
              dtype=torch.bfloat16,
              inputs: Optional[Tuple[str, ...]] = None) -> Dict[str, Any]:
    """Trace one case's step on ``mesh`` (a ``DeviceMesh`` over a fake
    group, or over real ranks) inside ``mode`` (entered by the caller),
    computing and caching in ``dtype`` (the sweep's bf16).  A prefill
    fills caches of ``pol.cache_len`` slots where it is set (a serving
    engine's, longer than the prompt), else of the prompt's length.
    ``inputs`` names the batch's inputs to plan (default every one
    ``make_batch_specs`` gives the shape: a VLM's image patches too).
    Returns the per-device argument bytes by part ("params", "opt" or
    "caches", "batch"); ``mode`` holds the tally of the step alone."""
    axes = mesh_axes(mesh)
    n_dev = 1
    for s in axes.values():
        n_dev *= s
    if pol.pure_dp and shape.global_batch % n_dev != 0:
        # pure-DP only pays when the global batch fills the whole mesh
        pol.pure_dp = False
    constraints.set_dp_axes(("pod", "data", "model") if pol.pure_dp
                            else None)
    dev = mesh.device_type
    flags = RunFlags(window=pol.window, mla_absorb=pol.mla_absorb,
                     block_q=pol.block_q, remat=pol.remat,
                     loss_chunk=pol.loss_chunk)
    lm = init_lm(cfg, 0, dtype=pol.param_dtype, device=dev)
    tree = lm.tree()
    psp = param_specs(axes, tree, fsdp=pol.fsdp, pure_dp=pol.pure_dp)
    params = LM(cfg, distribute(tree, psp, mesh))
    parts = {"params": local_bytes(tree, psp, axes)}
    bspecs = _fake_like({k: v for k, v in make_batch_specs(cfg, shape).items()
                         if inputs is None or k in inputs}, dev)
    bsp = batch_specs(axes, bspecs, shape, pure_dp=pol.pure_dp)
    batch = distribute(bspecs, bsp, mesh)
    parts["batch"] = local_bytes(bspecs, bsp, axes)
    if shape.kind == "train":
        init = adamw_init(tree, pol.moment_dtype)
        moments = {"mu": init["mu"], "nu": init["nu"]}
    del lm, tree
    try:
        with constraints.use_mesh(mesh):
            if shape.kind == "train":
                osp = opt_specs(axes, moments, fsdp=pol.fsdp,
                                pure_dp=pol.pure_dp)
                # the step count read on the host: a plain int here, as
                # a fake tensor has no value to read
                opt = dict(distribute(moments, osp, mesh), step=0)
                parts["opt"] = local_bytes(moments, osp, axes)
                tc = TrainConfig(dtype=torch.bfloat16,
                                 optim=AdamWConfig(
                                     moment_dtype=pol.moment_dtype),
                                 flags=flags)
                # the microbatches are alike: one is traced (a step of
                # one microbatch) and its work beyond the update counted
                # ``microbatches`` times
                mb = pol.microbatches
                micro = _split_micro(bspecs, mb)[0]
                mode.start()
                make_train_step(cfg, tc, mesh, pol.pure_dp)(params, opt,
                                                            micro)
                if mb > 1:
                    step = mode.tally()
                    with torch.no_grad():    # the update alone
                        adamw_update(tc.optim, params, params.tree(), opt,
                                     1.0)
                    mode.repeat(step, mb)
                return parts
            cache_len = (pol.cache_len or dec_len(cfg, shape.seq_len)
                         if shape.kind == "prefill" else pol.cache_len)
            caches = make_caches(cfg, shape.global_batch, cache_len,
                                 dtype, enc_len=pol.enc_len, device=dev)
            csp = cache_specs(axes, caches, shape, cfg, pure_dp=pol.pure_dp)
            parts["caches"] = local_bytes(caches, csp, axes)
            caches = distribute(caches, csp, mesh)
            with torch.no_grad():
                mode.start()
                if shape.kind == "prefill":
                    prefill(params, cfg, batch, caches, flags, dtype=dtype)
                else:
                    decode_step(params, cfg, caches, batch["tokens"],
                                pol.cache_len - 1, flags, dtype=dtype)
            return parts
    finally:
        mode.counting = False
        constraints.set_dp_axes(None)


def fake_group(world: int):
    """Initialise a ``"fake"`` default process group of ``world`` ranks,
    this process rank 0.  The caller destroys it."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)


def run_case(arch: str, shape_name: str, mesh_kind: str,
             overrides: Optional[Dict] = None, verbose: bool = True,
             cfg: Optional[ModelConfig] = None) -> Dict:
    """Plan one case on a fresh fake group (torn down after).  ``cfg``
    replaces ``get_config(arch)`` (a reduced config in tests)."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_production_mesh
    cfg = cfg or get_config(arch)
    shape = INPUT_SHAPES[shape_name]
    pol = case_policy(cfg, shape)
    for k, v in (overrides or {}).items():
        setattr(pol, k, v)
    rec: Dict[str, Any] = {"arch": arch, "shape": shape_name,
                           "mesh": mesh_kind,
                           "policy": {k: str(v) for k, v in
                                      dataclasses.asdict(pol).items()}}
    if pol.skip:
        rec["status"] = "skipped"
        rec["reason"] = pol.skip
        return rec
    multi = mesh_kind == "multi"
    chips = 512 if multi else 256
    t0 = time.time()
    fake_group(chips)
    try:
        mesh = make_production_mesh(multi_pod=multi, device="cpu")
        mode = PlanMode()
        with mode:
            parts = plan_case(cfg, shape, mesh, pol, mode)
        rep = analyze_plan(f"{arch}/{shape_name}/{mesh_kind}", mode,
                           chips=chips, arg_bytes=sum(parts.values()),
                           model_flops=model_flops_estimate(cfg, shape))
        rec.update(status="ok", plan_s=round(time.time() - t0, 2),
                   arg_bytes_by_part=parts, roofline=rep.as_dict())
        if verbose:
            print(f"[ok] {arch:24s} {shape_name:12s} {mesh_kind:6s} "
                  f"plan={time.time() - t0:6.1f}s flops/dev={rep.flops:.3e} "
                  f"mem/dev={(rep.arg_bytes + rep.temp_bytes) / 1e9:6.2f}GB "
                  f"coll/dev={rep.collective_bytes / 1e6:8.1f}MB "
                  f"dom={rep.dominant}", flush=True)
    except Exception as e:  # noqa: BLE001 — record and continue the sweep
        rec.update(status="error", error=f"{type(e).__name__}: {e}",
                   trace=traceback.format_exc()[-2000:])
        if verbose:
            print(f"[ERR] {arch} {shape_name} {mesh_kind}: {e}", flush=True)
    finally:
        dist.destroy_process_group()
    return rec


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="all", help="arch id or 'all'")
    ap.add_argument("--shape", default="all",
                    choices=["all"] + list(INPUT_SHAPES))
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--out", default=None, help="append JSONL records here")
    ap.add_argument("--quiet", action="store_true")
    args = ap.parse_args(argv)

    archs = list(ARCHS) if args.arch == "all" else [args.arch]
    shapes = list(INPUT_SHAPES) if args.shape == "all" else [args.shape]
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    cases = [(a, s, m, None, not args.quiet)
             for a in archs for s in shapes for m in meshes]

    n_ok = n_skip = n_err = 0
    for rec in _plan_all(cases, min(len(cases), os.cpu_count() or 1)):
        if args.out:
            os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
            with open(args.out, "a") as f:
                f.write(json.dumps(rec) + "\n")
        n_ok += rec["status"] == "ok"
        n_skip += rec["status"] == "skipped"
        n_err += rec["status"] == "error"
    print(f"\nDRY-RUN SUMMARY: ok={n_ok} skipped={n_skip} errors={n_err}")
    if n_err:
        raise SystemExit(1)


def _one_case(case) -> Dict:
    torch.set_num_threads(1)
    return run_case(*case)


def _plan_all(cases, jobs: int):
    """The cases' records in order, ``jobs`` processes at a time (one
    torch thread each)."""
    if jobs <= 1:
        yield from map(_one_case, cases)
        return
    import concurrent.futures
    import multiprocessing
    with concurrent.futures.ProcessPoolExecutor(
            jobs, mp_context=multiprocessing.get_context("spawn")) as ex:
        yield from ex.map(_one_case, cases)


if __name__ == "__main__":
    main()
