"""Roofline terms of a traced step (no card, nothing allocated).

Counterpart of the part of ``repro.analysis.roofline`` that the dry-run
uses.  The JAX package reads an AOT-compiled program; here a step runs
once on fake tensors (``FakeTensorMode``) over a fake process group, and
:class:`PlanMode` tallies what each rank's local operations would do:

* FLOPs per device — each local operation through ``torch.utils.
  flop_counter``'s formulas (the port's kernels' operators register
  theirs: ``repro_torch.kernels._ops``);
* bytes accessed per device — each local operation's inputs and outputs
  (views excluded), unfused, so an upper estimate of the HBM traffic;
* collective bytes per device — each functional collective DTensor
  issues, its output times the ring factor for its group size
  (:func:`.plan_cost.ring_factor`);
* temporary bytes — the peak of a live tally of the storages the step
  makes (a storage counts from its first tensor's birth to that tensor's
  death, so a view that outlives it is not held);
* beside these (:mod:`.plan_cost`): the products' FLOPs alone, the bytes
  a fusing compiler would move, and each collective's call site.

Argument bytes come from the sharding plan (``sharding.local_bytes``).
Terms (seconds, per device == per step under SPMD) against the H100's
datasheet figures (``repro_torch.analysis.bounds``):

    compute    = flops / PEAK_FLOPS_BF16
    memory     = bytes_accessed / HBM_BW      (memory_fused: bytes_fused)
    collective = collective_bytes / NVLINK_BW
"""

from __future__ import annotations

import dataclasses
import weakref
from collections import defaultdict
from typing import Any, Dict, List, Optional

import torch
from torch._subclasses.fake_tensor import FakeTensor, FakeTensorMode
from torch.utils.flop_counter import flop_registry

from repro_torch.analysis import plan_cost
from repro_torch.analysis.bounds import (
    CHIP_HBM_BYTES,
    HBM_BW,
    NVLINK_BW,
    PEAK_FLOPS_BF16,
)

_COLLECTIVES = {"all_gather_into_tensor": "all-gather",
                "reduce_scatter_tensor": "reduce-scatter",
                "all_reduce": "all-reduce",
                "all_to_all_single": "all-to-all"}


def _nbytes(x) -> int:
    return x.numel() * x.element_size() if isinstance(x, torch.Tensor) else 0


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, (list, tuple)):
        for t in tree:
            yield from _tensors(t)
    elif isinstance(tree, dict):
        for t in tree.values():
            yield from _tensors(t)


class PlanMode(FakeTensorMode):
    """``FakeTensorMode`` that tallies each local operation (one on fake
    tensors, not on the DTensors around them) while ``counting`` is on.
    DTensor infers an operation's output shapes by running it on whole
    (global) fake tensors in the active fake mode, once per distinct
    call; those runs are not counted (the propagator's method is wrapped
    while the mode is entered)."""

    def __init__(self):
        super().__init__(allow_non_fake_inputs=True)
        self.counting = False
        self.flops = 0
        self.bytes = 0
        self.coll_bytes: Dict[str, float] = defaultdict(float)
        self.coll_counts: Dict[str, int] = defaultdict(int)
        self.flops_by_op: Dict[str, int] = defaultdict(int)
        self.live = 0
        self.peak = 0
        self.fusion = plan_cost.FusionTally()
        self.sites = plan_cost.CollectiveSites()
        self._seen = set()
        self._groups: Dict[str, int] = {}

    def start(self) -> None:
        self.counting = True
        self.live = self.peak = 0

    def tally(self) -> Dict[str, Any]:
        """The counts so far (flops, bytes and collectives; the fused
        bytes saved and the collectives by call site)."""
        return {"flops": self.flops, "bytes": self.bytes,
                "coll_bytes": dict(self.coll_bytes),
                "coll_counts": dict(self.coll_counts),
                "flops_by_op": dict(self.flops_by_op),
                "fused_saved": self.fusion.saved(),
                "sites": self.sites.snapshot()}

    @property
    def bytes_fused(self) -> float:
        """The bytes of :attr:`bytes` a fusing compiler would still move
        (:class:`~repro_torch.analysis.plan_cost.FusionTally`)."""
        return self.bytes - self.fusion.saved()

    def repeat(self, step: Dict[str, Any], times: int) -> None:
        """``step`` is the tally after a step of one microbatch and its
        update, and the work since it an update alone: count the
        microbatch's work ``times`` times and the update once
        (identical microbatches traced once)."""
        def total(at_step, now):
            update = now - at_step
            return times * (at_step - update) + update

        self.flops = total(step["flops"], self.flops)
        self.bytes = total(step["bytes"], self.bytes)
        for name in ("coll_bytes", "coll_counts", "flops_by_op"):
            now, then = getattr(self, name), step[name]
            for k in set(now) | set(then):
                now[k] = total(then.get(k, 0), now.get(k, 0))
        self.fusion.scale(step["fused_saved"], times)
        self.sites.scale(step["sites"], times)

    def __enter__(self):
        self._depth = getattr(self, "_depth", 0) + 1
        if self._depth > 1:   # re-entered by each fake tensor's dispatch
            return super().__enter__()
        from torch.distributed.tensor._sharding_prop import ShardingPropagator
        name = next(n for n in ("_propagate_tensor_meta_non_cached",
                                "_propagate_tensor_meta")
                    if hasattr(ShardingPropagator, n))
        orig = getattr(ShardingPropagator, name)
        mode = self

        def quiet(prop, *args, **kwargs):
            was, mode.counting = mode.counting, False
            try:
                return orig(prop, *args, **kwargs)
            finally:
                mode.counting = was

        self._patched = (ShardingPropagator, name, orig)
        setattr(ShardingPropagator, name, quiet)
        return super().__enter__()

    def __exit__(self, *exc):
        self._depth -= 1
        if self._depth == 0:
            cls, name, orig = self._patched
            setattr(cls, name, orig)
        return super().__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = super().__torch_dispatch__(func, types, args, kwargs)
        if not self.counting or out is NotImplemented:
            return out
        ins = [t for t in _tensors((args, kwargs or {}))
               if isinstance(t, FakeTensor)]
        if not ins and not any(isinstance(t, FakeTensor)
                               for t in _tensors(out)):
            return out
        packet = func._overloadpacket
        name = packet.__name__
        if name in _COLLECTIVES:
            self._collective(name, args, out)
        elif packet in flop_registry:
            n = flop_registry[packet](*args, **(kwargs or {}), out_val=out)
            self.flops += n
            self.flops_by_op[name] += n
        if not _is_view(func):
            outs = [t for t in _tensors(out) if isinstance(t, FakeTensor)]
            self.bytes += sum(map(_nbytes, ins)) + sum(
                map(_nbytes, _tensors(out)))
            self.fusion.op(func, ins, outs)
            for t in _tensors(out):
                self._born(t)
        return out

    def _collective(self, name, args, out) -> None:
        from torch.distributed.distributed_c10d import _resolve_process_group
        op = _COLLECTIVES[name]
        if args[-1] not in self._groups:
            self._groups[args[-1]] = _resolve_process_group(args[-1]).size()
        group = self._groups[args[-1]]
        wire = _nbytes(out) * plan_cost.ring_factor(op, group)
        self.coll_bytes[op] += wire
        self.coll_counts[op] += 1
        self.sites.add(op, group, wire)

    def _born(self, t: torch.Tensor) -> None:
        try:
            key = t.untyped_storage()._cdata
        except (RuntimeError, NotImplementedError):
            return
        if key in self._seen:
            return
        n = t.untyped_storage().nbytes()
        self._seen.add(key)
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(t, self._died, key, n)

    def _died(self, key, n) -> None:
        self._seen.discard(key)
        self.live -= n


def _is_view(func) -> bool:
    return bool(getattr(func, "is_view", False)) or \
        func._overloadpacket.__name__ in ("detach", "view", "_unsafe_view",
                                          "alias", "t", "transpose",
                                          "permute", "expand", "unsqueeze",
                                          "squeeze", "slice", "select",
                                          "as_strided", "split")


@dataclasses.dataclass
class RooflineReport:
    name: str
    flops: float                    # per device
    bytes_accessed: float           # per device
    collective_bytes: float         # per device
    compute_s: float
    memory_s: float
    collective_s: float
    dominant: str
    model_flops: Optional[float] = None   # 6·N·D (or 6·N_active·D) global
    useful_ratio: Optional[float] = None  # model_flops / (flops · chips)
    arg_bytes: int = 0
    temp_bytes: int = 0
    out_bytes: int = 0
    fits_hbm: Optional[bool] = None
    collectives: Optional[Dict] = None
    dot_flops: float = 0.0          # per device, products only
    bytes_fused: float = 0.0        # per device, a fusing compiler's
    memory_fused_s: float = 0.0
    top_collectives: Optional[List[Dict]] = None

    def as_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


def analyze_plan(name: str, mode: PlanMode, *, chips: int, arg_bytes: int,
                 out_bytes: int = 0,
                 model_flops: Optional[float] = None) -> RooflineReport:
    """The report of one traced step from its :class:`PlanMode` tally."""
    flops, byts = float(mode.flops), float(mode.bytes)
    cbytes = float(sum(mode.coll_bytes.values()))
    compute_s = flops / PEAK_FLOPS_BF16
    memory_s = byts / HBM_BW
    coll_s = cbytes / NVLINK_BW
    dom = max(("compute", compute_s), ("memory", memory_s),
              ("collective", coll_s), key=lambda kv: kv[1])[0]
    useful = None
    if model_flops:
        useful = model_flops / max(flops * chips, 1.0)
    colls = {"bytes_by_op": {k: int(v) for k, v in mode.coll_bytes.items()},
             "counts": dict(mode.coll_counts),
             "total_bytes": int(cbytes)}
    return RooflineReport(
        name=name, flops=flops, bytes_accessed=byts, collective_bytes=cbytes,
        compute_s=compute_s, memory_s=memory_s, collective_s=coll_s,
        dominant=dom, model_flops=model_flops, useful_ratio=useful,
        arg_bytes=int(arg_bytes), temp_bytes=int(mode.peak),
        out_bytes=int(out_bytes),
        fits_hbm=(arg_bytes + mode.peak + out_bytes) < CHIP_HBM_BYTES,
        collectives=colls,
        dot_flops=plan_cost.dot_flops(mode.flops_by_op),
        bytes_fused=float(mode.bytes_fused),
        memory_fused_s=float(mode.bytes_fused) / HBM_BW,
        top_collectives=plan_cost.top_collectives(mode))


def model_flops_estimate(cfg, shape) -> float:
    """6·N·D for training, 2·N·D for a forward/prefill, 2·N_active per
    decoded token (N = active params)."""
    n_act = cfg.active_param_count()
    tokens = shape.global_batch * shape.seq_len
    if shape.kind == "train":
        return 6.0 * n_act * tokens
    if shape.kind == "prefill":
        return 2.0 * n_act * tokens
    return 2.0 * n_act * shape.global_batch  # decode: one token per request
