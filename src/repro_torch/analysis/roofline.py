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
:class:`CommTally` counts a real run's collectives in the same terms, so
a run can be held to its plan.
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
from torch.utils._python_dispatch import TorchDispatchMode
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
                "all_to_all_single": "all-to-all",
                # DTensor's move of a split from one dim to another, where
                # the group does all-to-all (NCCL; gloo on CUDA tensors)
                "shard_dim_alltoall": "all-to-all"}


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
    DTensor infers an operation's output shapes, and the strategy of an
    operation it only knows by its decomposition, by running them on whole
    (global) fake tensors in the active fake mode, once per distinct
    call; those runs are not counted (the propagator's methods are
    wrapped while the mode is entered).

    ``alltoall``: whether the planned group does all-to-all, as NCCL and
    gloo on CUDA tensors do (a card's run): DTensor then moves a split
    from one dim to another with one all-to-all, which the planner's
    fake group on the CPU would otherwise replace, as a CPU group does,
    by an all-gather and a slice (False: a run on the CPU)."""

    def __init__(self, alltoall: bool = True):
        super().__init__(allow_non_fake_inputs=True)
        self.alltoall = alltoall
        self.counting = False
        self.flops = 0
        self.bytes = 0
        self.coll_bytes: Dict[str, float] = defaultdict(float)
        self.coll_counts: Dict[str, int] = defaultdict(int)
        self.flops_by_op: Dict[str, int] = defaultdict(int)
        self.flops_by_site: Dict[str, float] = defaultdict(float)
        self.live = 0
        self.peak = 0
        self.peak_sites: Dict[str, List[int]] = {}
        self._live_sites: Dict[int, tuple] = {}
        self._at_peak = False
        self.fusion = plan_cost.FusionTally()
        self.sites = plan_cost.CollectiveSites()
        self._seen = set()
        self._groups: Dict[str, int] = {}

    def start(self) -> None:
        self.counting = True
        self.live = self.peak = 0
        self.peak_sites = {}
        self._at_peak = False

    def tally(self) -> Dict[str, Any]:
        """The counts so far (flops, bytes and collectives; the fused
        bytes saved and the collectives by call site)."""
        return {"flops": self.flops, "bytes": self.bytes,
                "coll_bytes": dict(self.coll_bytes),
                "coll_counts": dict(self.coll_counts),
                "flops_by_op": dict(self.flops_by_op),
                "flops_by_site": dict(self.flops_by_site),
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
        for name in ("coll_bytes", "coll_counts", "flops_by_op",
                     "flops_by_site"):
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
        # the output shapes, and the strategies that an operation without
        # rules of its own takes from its decomposition run on whole fake
        # tensors: both are propagation, not a rank's work
        names = [n for n in ("_propagate_tensor_meta_non_cached",
                             "_propagate_tensor_meta",
                             "propagate_op_sharding_non_cached")
                 if hasattr(ShardingPropagator, n)]
        mode = self

        def quiet(orig):
            def run(prop, *args, **kwargs):
                was, mode.counting = mode.counting, False
                try:
                    return orig(prop, *args, **kwargs)
                finally:
                    mode.counting = was
            return run

        self._patched = [(ShardingPropagator, n,
                          getattr(ShardingPropagator, n)) for n in names]
        for cls, n, orig in self._patched:
            setattr(cls, n, quiet(orig))
        if self.alltoall:
            self._patched += _alltoall_route()
        # each autograd node keeps its forward operation's site (anomaly
        # mode's stack, cut to the site), so that a backward operation is
        # tallied at the site that needed it
        import torch.fx.traceback as fx_traceback
        self._anomaly = (torch.is_anomaly_enabled(),
                         torch.is_anomaly_check_nan_enabled(),
                         fx_traceback.format_stack)
        fx_traceback.format_stack = plan_cost.site_stack
        torch.autograd.set_detect_anomaly(True, check_nan=False)
        return super().__enter__()

    def __exit__(self, *exc):
        self._depth -= 1
        if self._depth == 0:
            for cls, name, orig in self._patched:
                setattr(cls, name, orig)
            import torch.fx.traceback as fx_traceback
            torch.autograd.set_detect_anomaly(*self._anomaly[:2])
            fx_traceback.format_stack = self._anomaly[2]
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
        site = None
        if name in _COLLECTIVES:
            self._collective(name, args, out)
        elif packet in flop_registry:
            n = flop_registry[packet](*args, **(kwargs or {}), out_val=out)
            self.flops += n
            self.flops_by_op[name] += n
            site = _op_site()
            self.flops_by_site[site] += n
        if not _is_view(func):
            outs = [t for t in _tensors(out) if isinstance(t, FakeTensor)]
            self.bytes += sum(map(_nbytes, ins)) + sum(
                map(_nbytes, _tensors(out)))
            self.fusion.op(func, ins, outs)
            for t in _tensors(out):
                if site is None:
                    site = _op_site()
                self._born(t, site)
        return out

    def _collective(self, name, args, out) -> None:
        op, group, wire = _wire(name, args, out, self._groups)
        self.coll_bytes[op] += wire
        self.coll_counts[op] += 1
        self.sites.add(op, group, wire)

    def _born(self, t: torch.Tensor, site: str) -> None:
        try:
            key = t.untyped_storage()._cdata
        except (RuntimeError, NotImplementedError):
            return
        if key in self._seen:
            return
        n = t.untyped_storage().nbytes()
        self._seen.add(key)
        self._live_sites[key] = (n, site)
        self.live += n
        if self.live > self.peak:
            self.peak, self._at_peak = self.live, True
        weakref.finalize(t, self._died, key, n)

    def _died(self, key, n) -> None:
        if self._at_peak:    # the live set at the peak, by site
            self._snap_peak()
        self._seen.discard(key)
        self._live_sites.pop(key, None)
        self.live -= n

    def _snap_peak(self) -> None:
        sites: Dict[str, List[int]] = {}
        for n, site in self._live_sites.values():
            row = sites.setdefault(site, [0, 0])
            row[0] += 1
            row[1] += n
        self.peak_sites, self._at_peak = sites, False

    def live_at_peak(self) -> Dict[str, List[int]]:
        """``{site: [storages, bytes]}`` alive at the peak so far."""
        if self._at_peak:
            self._snap_peak()
        return self.peak_sites


def _alltoall_route():
    """Point DTensor's move of a split between dims at its all-to-all
    operator whatever the mesh's device (its CPU route is an all-gather
    and a slice); returns the (module, name, original) patched."""
    from torch.distributed.tensor import _collective_utils, placement_types
    mods = [m for m in (placement_types, _collective_utils)
            if hasattr(m, "shard_dim_alltoall")]
    if not mods:
        raise RuntimeError("DTensor has no shard_dim_alltoall to plan")

    def alltoall(input, gather_dim, shard_dim, mesh, mesh_dim):
        return torch.ops._dtensor.shard_dim_alltoall(
            input, gather_dim, shard_dim, mesh.get_group(mesh_dim).group_name)

    patched = [(m, "shard_dim_alltoall", m.shard_dim_alltoall) for m in mods]
    for m in mods:
        m.shard_dim_alltoall = alltoall
    return patched


def _wire(name, args, out, groups: Dict[str, int]):
    """(operation, group size, wire bytes a rank) of a functional
    collective: its output's bytes times the ring factor for its group
    (``groups`` caches the sizes by group name)."""
    from torch.distributed.distributed_c10d import _resolve_process_group
    op = _COLLECTIVES[name]
    if args[-1] not in groups:
        groups[args[-1]] = _resolve_process_group(args[-1]).size()
    group = groups[args[-1]]
    return op, group, _nbytes(out) * plan_cost.ring_factor(op, group)


def _op_site() -> str:
    """The call site of the operation being dispatched
    (:func:`.plan_cost.op_site`)."""
    return plan_cost.op_site(torch._C._current_autograd_node())


class CommTally(TorchDispatchMode):
    """The functional collectives a real run issues (DTensor's
    redistributions and the model's own reductions), counted as
    :class:`PlanMode` counts them: ``bytes`` (wire bytes a rank) and
    ``counts`` by operation.  Enter it around the run on each rank."""

    def __init__(self):
        super().__init__()
        self.bytes: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)
        self._groups: Dict[str, int] = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        if any(issubclass(t, DTensor) for t in types):
            # DTensor first: its redistributions come back here as the
            # collectives they issue
            return NotImplemented
        out = func(*args, **(kwargs or {}))
        name = func._overloadpacket.__name__
        if name in _COLLECTIVES:
            op, _, wire = _wire(name, args, out, self._groups)
            self.bytes[op] += wire
            self.counts[op] += 1
        return out


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
    top_flops: Optional[List[Dict]] = None
    top_live: Optional[List[Dict]] = None

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
        top_collectives=plan_cost.top_collectives(mode),
        top_flops=plan_cost.top_flops(mode),
        top_live=plan_cost.top_live(mode))


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
