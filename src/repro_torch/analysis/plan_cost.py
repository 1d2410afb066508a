"""Cost model of a traced plan (counterpart of ``repro.analysis.hlo_cost``).

The JAX package costs a compiled HLO module.  The port has no HLO: its
program is the trace that :class:`repro_torch.analysis.roofline.PlanMode`
sees, one local operation at a time, on fake tensors over a fake process
group.  This module gives that trace what ``hlo_cost`` gives JAX's dry
run:

* **dot FLOPs** (:func:`dot_flops`): ``2·M·N·K·batch`` for every product
  (``mm``, ``addmm``, ``bmm``, ``baddbmm``, convolutions, the attention
  operators, whose formulas count their two products), beside the
  all-operation FLOPs ``PlanMode`` counts.  ``hlo_cost`` counts dots only,
  so this is the number to hold against it;
* **fused bytes** (:class:`FusionTally`): ``PlanMode``'s bytes count every
  local operation's inputs and outputs, what eager PyTorch moves.  A
  fusing compiler moves less: here a pointwise operation's output that
  exactly one later pointwise operation reads, and nothing else, is
  neither written nor read (it stays in registers inside one fused
  kernel); views stay free; everything else counts as before.  Whether an
  output is read once is known only when it can no longer be read (its
  storage written again or freed, or the tally read), so each output is
  settled then;
* **top FLOPs and live bytes** (:func:`top_flops`, :func:`top_live`): the
  FLOPs by call site, and the storages alive at the temporaries' peak by
  the site that made them;
* **top collectives** (:class:`CollectiveSites`, :func:`top_collectives`):
  each collective's wire bytes (its output times :func:`ring_factor` for
  its group) by (operation, group size, call site), the call site being
  the model code that needed it (``module:line``, and the constraint that
  issued it, :func:`_site`), the counterpart of ``hlo_cost``'s ``op_name``
  metadata.

Nothing here imports ``roofline``; ``PlanMode`` feeds these tallies.
"""

from __future__ import annotations

import os
import sys
from collections import defaultdict
from typing import Dict, List

import torch

_DOTS = {"mm", "addmm", "bmm", "baddbmm", "convolution",
         "convolution_backward", "attention", "attention_vjp"}
_DOT_PREFIXES = ("_scaled_dot_product", "_flash_attention",
                 "_efficient_attention", "_cudnn_attention")

_PACKAGE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_ANALYSIS = os.path.dirname(os.path.abspath(__file__))
_CONSTRAINTS = os.path.join(_PACKAGE, "distribution", "constraints.py")
_CHECKPOINT = torch.utils.checkpoint.__file__


def ring_factor(op: str, g: int) -> float:
    """Per-device wire bytes as a multiple of the op's *output* bytes, under
    standard ring-algorithm accounting with group size g."""
    if g <= 1:
        return 0.0
    if op == "all-gather":
        return (g - 1) / g
    if op == "reduce-scatter":
        return float(g - 1)           # input = g × output; (g-1)/g × input
    if op == "all-reduce":
        return 2.0 * (g - 1) / g
    if op == "all-to-all":
        return (g - 1) / g
    return 1.0                        # collective-permute


def is_dot(name: str) -> bool:
    """Whether the operator ``name`` (an overload packet's name) is a
    product whose FLOP formula counts 2·M·N·K."""
    return name in _DOTS or name.startswith(_DOT_PREFIXES)


def dot_flops(flops_by_op: Dict[str, float]) -> float:
    """The products' FLOPs among ``PlanMode``'s FLOPs by operator."""
    return float(sum(v for k, v in flops_by_op.items() if is_dot(k)))


def _storage(t: torch.Tensor):
    try:
        return t.untyped_storage()._cdata
    except (RuntimeError, NotImplementedError):
        return None


class FusionTally:
    """The bytes a fusing compiler would not move, from a stream of local
    operations (:meth:`op`).  Each output is a value on its storage: the
    storage's reads until it is written again are the value's readers."""

    def __init__(self):
        self._current: Dict[int, list] = {}   # storage -> value
        self._settled = 0.0                   # saved bytes, values done
        self._offset = 0.0                    # repeat()'s correction

    @staticmethod
    def _saved(value) -> float:
        # [pointwise producer, write bytes, readers, read bytes,
        #  every reader pointwise]
        pw, write, readers, read, all_pw = value
        return float(write + read) if pw and readers == 1 and all_pw else 0.0

    def op(self, func, ins, outs) -> None:
        """One counted local operation reading tensors ``ins`` and writing
        ``outs``; a ``prim`` query of a tensor's metadata moves nothing
        (the unfused count has its inputs)."""
        if func.namespace == "prim":          # metadata (prim.device)
            self._settled += sum(t.numel() * t.element_size() for t in ins)
            return
        pointwise = torch.Tag.pointwise in getattr(func, "tags", ())
        for t in ins:
            v = self._current.get(_storage(t))
            if v is not None:
                v[2] += 1
                v[3] += t.numel() * t.element_size()
                v[4] = v[4] and pointwise
        for t in outs:
            key = _storage(t)
            if key is None:
                continue
            old = self._current.get(key)
            if old is not None:
                self._settled += self._saved(old)
            self._current[key] = [pointwise, t.numel() * t.element_size(),
                                  0, 0, True]

    def saved(self) -> float:
        """Bytes saved so far, every value read as it stands."""
        return (self._settled + self._offset
                + sum(map(self._saved, self._current.values())))

    def scale(self, at_step: float, times: int) -> None:
        """``at_step`` was :meth:`saved` after a step of one microbatch and
        its update, and the work since is an update alone: count the
        microbatch's savings ``times`` times (``PlanMode.repeat``)."""
        now = self.saved()
        update = now - at_step
        self._offset += times * (at_step - update) + update - now


def op_site(node) -> str:
    """The call site of an operation dispatched while the autograd
    ``node`` (or None) runs: in a backward pass, the site of the forward
    operation whose gradient it computes (:func:`node_site`), unless
    checkpointing is recomputing a forward pass, whose operations are
    their own model frame's, marked ``(recompute)``; else :func:`_site`."""
    if node is None:
        return _site()
    frames, recompute = [], False
    f = sys._getframe(1)
    while f is not None:
        frames.append((f.f_code.co_filename, f.f_lineno, f.f_code.co_name))
        recompute = recompute or f.f_code.co_filename == _CHECKPOINT
        f = f.f_back
    if not recompute:
        return node_site(node)
    site = _site_of(frames)
    return f"{site} (recompute)" if site else ""


def _site() -> str:
    """``module:line`` of the innermost ``repro_torch`` frame outside the
    analysis modules and ``distribution.constraints`` (the model code
    whose operation or constraint needed the collective), followed by
    ``" via constraints:line"`` where a constraint issued it; the
    constraint's frame alone if no other ``repro_torch`` frame calls it;
    ``""`` if none."""
    def frames():
        f = sys._getframe(2)
        while f is not None:
            yield f.f_code.co_filename, f.f_lineno, f.f_code.co_name
            f = f.f_back
    return _site_of(frames())


def node_site(node) -> str:
    """:func:`_site` of the forward operation that made the autograd
    ``node``, followed by ``" (backward)"``: the stack anomaly mode keeps
    in each node's metadata, which under ``PlanMode`` is that site alone
    (:func:`site_stack`); ``""`` without one."""
    meta = node.metadata
    if "plan_site" not in meta:
        site = (meta.get("traceback_") or [""])[-1]
        meta["plan_site"] = f"{site} (backward)" if site else ""
    return meta["plan_site"]


def site_stack() -> List[str]:
    """The stack anomaly mode keeps for a new autograd node, in
    ``PlanMode``: its :func:`_site` alone (formatting every frame of every
    node's stack would slow a training step's plan several times over)."""
    return [_site()]


def _site_of(frames) -> str:
    """:func:`_site` over ``(file, line, function)`` triples, innermost
    first.  A mode's hook in the constraints (``__torch_function__``, the
    products reduced where made) is not a site: the product is its
    caller's."""
    inner = None
    for fname, line, func in frames:
        path = os.path.abspath(fname)
        if path == _CONSTRAINTS and func == "__torch_function__":
            continue
        if path.startswith(_PACKAGE) and not path.startswith(_ANALYSIS):
            rel = os.path.relpath(path, os.path.dirname(_PACKAGE))
            here = f"{rel[:-3].replace(os.sep, '.')}:{line}"
            if path != _CONSTRAINTS:
                return here if inner is None else f"{here} via {inner}"
            inner = inner or here
    return inner or ""


class CollectiveSites:
    """Collectives by (operation, group size, call site): count and wire
    bytes."""

    def __init__(self):
        self.rows: Dict[tuple, List[float]] = defaultdict(lambda: [0, 0.0])

    def add(self, op: str, group: int, wire: float) -> None:
        row = self.rows[(op, group, _site())]
        row[0] += 1
        row[1] += wire

    def scale(self, at_step: Dict[tuple, List[float]], times: int) -> None:
        """As :meth:`FusionTally.scale`, for each row (``at_step`` a copy
        of :attr:`rows` after the microbatch's step and its update)."""
        for key in set(self.rows) | set(at_step):
            then = at_step.get(key, [0, 0.0])
            now = self.rows[key]
            for i in (0, 1):
                update = now[i] - then[i]
                now[i] = times * (then[i] - update) + update

    def snapshot(self) -> Dict[tuple, List[float]]:
        return {k: list(v) for k, v in self.rows.items()}


def top_collectives(mode, k: int = 20) -> List[Dict]:
    """The ``k`` largest collectives of a :class:`~repro_torch.analysis.
    roofline.PlanMode` tally by wire bytes a device: ``{"op", "group",
    "count", "bytes", "site"}``, ``site`` the ``repro_torch`` frame that
    issued them (``module:line``)."""
    rows = [{"op": op, "group": g, "count": int(c), "bytes": int(b),
             "site": site}
            for (op, g, site), (c, b) in mode.sites.rows.items()]
    rows.sort(key=lambda r: (-r["bytes"], -r["count"], r["site"]))
    return rows[:k]


def top_flops(mode, k: int = 20) -> List[Dict]:
    """The ``k`` call sites of a :class:`~repro_torch.analysis.roofline.
    PlanMode` tally with the most FLOPs a device: ``{"site", "flops"}``
    (a backward operation under its forward operation's site, marked
    ``(backward)``), the counterpart of JAX's dot FLOPs by ``op_name``."""
    rows = [{"site": site, "flops": float(f)}
            for site, f in mode.flops_by_site.items() if f]
    rows.sort(key=lambda r: (-r["flops"], r["site"]))
    return rows[:k]


def top_live(mode, k: int = 20) -> List[Dict]:
    """The ``k`` call sites holding the most temporary bytes at the
    step's peak: ``{"site", "bytes", "count"}`` (storages alive then, by
    the site that made them)."""
    rows = [{"site": site, "bytes": int(b), "count": int(c)}
            for site, (c, b) in mode.live_at_peak().items()]
    rows.sort(key=lambda r: (-r["bytes"], r["site"]))
    return rows[:k]
