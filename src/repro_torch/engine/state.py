"""Batched protocol state as NamedTuple records of tensors (counterpart of
``repro.engine.state``).

A *sweep* is B independent protocol instances of one selector (same party
count k and dimension d, possibly different datasets, shard sizes, error
budgets and seeds) advanced in lock-step by the selector's ``step``:
:class:`ProtocolState` for MEDIAN, :class:`MaxMargState` for MAXMARG, and
:class:`UnifiedState`, the superset that one mixed MEDIAN + MAXMARG +
SAMPLING dispatch advances.  The shapes and padding rules are the JAX
package's, leaf for leaf:

* shards are padded to a common ``n_max`` with **label-0 rows** — inert in
  every masked reduction;
* per-node transcript buffers have static capacity ``cap`` plus a fill
  counter; rows at or beyond the fill always carry label 0;
* communication is accounted in :class:`BatchCommLog`, one int32 counter per
  instance, lowered to ``CommLog.summary()``-shaped dicts at the end.

Every record lives on one explicit device, or — packed with ``mesh=`` — is
split over a 1-D ``("data",)`` device mesh (:func:`device_put_sharded`): a
tuple of S records of the same type, shard s's slice of every batched leaf
on ``mesh.devices[s]``.  :func:`from_reference` turns the JAX package's
packed records (as numpy arrays) into the port's, so the tests run both
packages on identical inputs.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import _device
from repro_torch.core import prng
from repro_torch.core.comm import wire_bytes
from repro_torch.core.sampling import EPSILON_NET_C, epsilon_net_size

# per-instance selector codes of the unified mixed-selector state: data in
# a (B,) int32 leaf, so a mix never changes the launched program; 0 doubles
# as the inert value of gathered padding rows (a label-0 MEDIAN row is the
# engine's no-op instance)
SEL_MEDIAN = 0
SEL_MAXMARG = 1
SEL_SAMPLING = 2
SELECTOR_CODES = {"median": SEL_MEDIAN, "maxmarg": SEL_MAXMARG,
                  "sampling": SEL_SAMPLING}
SELECTOR_NAMES = {v: k for k, v in SELECTOR_CODES.items()}


class BatchCommLog(NamedTuple):
    """Vectorized communication ledger: one int32 counter per instance,
    field-for-field :class:`repro_torch.core.comm.CommStats`; ``rounds``
    counts protocol *turns* exactly like ``CommLog.new_round()``."""

    points: torch.Tensor    # (B,) i32
    scalars: torch.Tensor   # (B,) i32
    bits: torch.Tensor      # (B,) i32
    messages: torch.Tensor  # (B,) i32
    rounds: torch.Tensor    # (B,) i32

    def summary(self, i: int, dim: int) -> Dict[str, Any]:
        """Lower instance ``i`` to the exact dict ``CommLog.summary()`` emits."""
        p = int(self.points[i])
        s = int(self.scalars[i])
        b = int(self.bits[i])
        return {
            "points": p,
            "scalars": s,
            "bits": b,
            "messages": int(self.messages[i]),
            "rounds": int(self.rounds[i]),
            "bytes": wire_bytes(p, s, b, dim),
        }

    def summaries(self, dim: int) -> List[Dict[str, Any]]:
        host = BatchCommLog(*(a.cpu().numpy() for a in self))
        return [host.summary(i, dim) for i in range(host.points.shape[0])]


class ProtocolState(NamedTuple):
    """Per-instance protocol state advanced by ``median.step``.

    All leading axes are the batch axis B, including ``turn``: the
    coordinator index ``ci = turn % k`` is per-instance.  A lock-step sweep
    keeps every row's turn identical.
    """

    dir_ok: torch.Tensor     # (B, m) bool — allowed direction arc
    wx: torch.Tensor         # (B, k, cap, d) f32 — per-node transcript points
    wy: torch.Tensor         # (B, k, cap) i32 — transcript labels (0 = empty)
    w_fill: torch.Tensor     # (B, k) i32 — transcript fill counters
    lo_w: torch.Tensor       # (B, k, m) f32 — running per-node threshold lo
    hi_w: torch.Tensor       # (B, k, m) f32 — running per-node threshold hi
    turn: torch.Tensor       # (B,) i32 — per-instance turn counter
    done: torch.Tensor       # (B,) bool
    converged: torch.Tensor  # (B,) bool
    epochs: torch.Tensor     # (B,) i32 — 1-based epoch at termination
    h_v: torch.Tensor        # (B, d) f32 — current hypothesis direction
    h_t: torch.Tensor        # (B,) f32 — current hypothesis threshold
    h_valid: torch.Tensor    # (B,) bool
    comm: BatchCommLog


class MaxMargState(NamedTuple):
    """Per-instance MAXMARG protocol state advanced by ``maxmarg.step``.

    Same conventions as :class:`ProtocolState` (leading batch axis B,
    per-instance ``turn``, label-0 transcript padding) but no direction
    grid: the selector refits a max-margin separator every turn.
    Transcripts hold *received* points only.  ``h_w``/``h_b`` hold the
    latest proposal (the result, and the single-carry warm init);
    ``c_w``/``c_b``/``c_valid`` each node's carried separator — the latest
    proposal that node verified clean on everything it knows — with
    ``warm_node`` tracking whether it still classifies the node's grown
    transcript cleanly; ``latches`` counts refits whose warm gate passed
    (observability only).
    """

    wx: torch.Tensor         # (B, k, cap, d) f32 — received-point transcripts
    wy: torch.Tensor         # (B, k, cap) i32 — transcript labels (0 = empty)
    w_fill: torch.Tensor     # (B, k) i32 — live transcript length per node
    turn: torch.Tensor       # (B,) i32 — per-instance turn counter
    done: torch.Tensor       # (B,) bool
    converged: torch.Tensor  # (B,) bool
    epochs: torch.Tensor     # (B,) i32 — 1-based epoch at termination
    h_w: torch.Tensor        # (B, d) f32 — current hypothesis weights
    h_b: torch.Tensor        # (B,) f32 — current hypothesis offset
    h_valid: torch.Tensor    # (B,) bool — (h_w, h_b) is a fitted separator
    warm_turn: torch.Tensor  # (B,) bool — latest proposal classified the
    #                          next coordinator's shard cleanly
    c_w: torch.Tensor        # (B, k, d) f32 — per-node carried separators
    c_b: torch.Tensor        # (B, k) f32
    c_valid: torch.Tensor    # (B, k) bool — node has a carry
    warm_node: torch.Tensor  # (B, k) bool — the carry still classifies the
    #                          node's grown transcript cleanly
    latches: torch.Tensor    # (B,) i32 — warm-gate hits (observability)
    comm: BatchCommLog


class EngineData(NamedTuple):
    """Per-instance constants of a sweep."""

    X: torch.Tensor       # (B, k, n_max, d) f32, zero-padded rows
    y: torch.Tensor       # (B, k, n_max) i32 ±1 (0 = padding)
    budget: torch.Tensor  # (B,) i32 — floor(eps * n_total)


@dataclasses.dataclass(frozen=True)
class ProtocolInstance:
    """One protocol problem: k shards plus an error budget ε and a selector;
    ``seed`` keys per-instance randomness of the one-way "sampling"
    selector."""

    shards: Sequence[Tuple[np.ndarray, np.ndarray]]
    eps: float = 0.05
    selector: str = "median"
    seed: int = 0


def _round_up(x: int, mult: int) -> int:
    return ((x + mult - 1) // mult) * mult


def tree_map(fn, *trees):
    """Apply ``fn`` leaf-wise over NamedTuple records of tensors."""
    if isinstance(trees[0], tuple):
        return type(trees[0])(*(tree_map(fn, *leaves)
                                for leaves in zip(*trees)))
    return fn(*trees)


def _leaves(tree) -> list:
    if isinstance(tree, tuple):
        return [a for t in tree for a in _leaves(t)]
    return [tree]


def shard_specs(tree):
    """The engine's one sharding rule, leaf for leaf as the JAX package's
    ``PartitionSpec`` pytree: axis 0 of every batched leaf splits over the
    mesh's "data" axis (``("data", None, ...)``), scalar leaves replicate
    (``()``).  Works on any engine record — :class:`EngineData`,
    :class:`ProtocolState`, :class:`MaxMargState` — of tensors or numpy
    arrays."""
    return tree_map(lambda a: () if np.ndim(a) == 0
                    else ("data",) + (None,) * (np.ndim(a) - 1), tree)


def _shard_leaf(a, s: int, b_loc: int, dev: torch.device) -> torch.Tensor:
    t = a if torch.is_tensor(a) else torch.from_numpy(np.ascontiguousarray(a))
    if t.ndim:
        t = t[s * b_loc:(s + 1) * b_loc]
    return t.to(dev, copy=True).contiguous()


def device_put_sharded(tree, mesh) -> tuple:
    """Split an engine record over ``mesh`` under :func:`shard_specs`: a
    tuple of S records of the same type, shard s holding rows ``[s·B/S,
    (s+1)·B/S)`` of every batched leaf (and a copy of every scalar leaf) on
    ``mesh.devices[s]``.  Host (numpy) leaves upload straight to their
    shards, so a packed sweep is born sharded.  Every shard gets tensors of
    its own, also where the mesh repeats a device: no shard is a view of
    another's buffer or of the input."""
    S = int(mesh.shape["data"])
    B = next(np.shape(a)[0] for a in _leaves(tree) if np.ndim(a))
    if B % S:
        raise ValueError(f"B={B} not divisible by mesh axis {S}; pack with "
                         f"mesh=")
    return tuple(tree_map(functools.partial(_shard_leaf, s=s, b_loc=B // S,
                                            dev=dev), tree)
                 for s, dev in enumerate(mesh.devices))


def as_shards(tree, mesh) -> tuple:
    """An engine record split over ``mesh``: as it is when it already is
    (a plain tuple of per-shard records), else :func:`device_put_sharded`."""
    if isinstance(tree, tuple) and not hasattr(tree, "_fields"):
        if len(tree) != int(mesh.shape["data"]):
            raise ValueError(f"{len(tree)} shards for a mesh of "
                             f"{mesh.shape['data']}")
        return tree
    return device_put_sharded(tree, mesh)


def unshard(parts, device="cpu"):
    """The one record that the shards of :func:`device_put_sharded` split:
    batched leaves concatenated in shard order on ``device``, scalar leaves
    from shard 0."""
    dev = torch.device(device)
    return tree_map(lambda *ls: ls[0].to(dev) if ls[0].ndim == 0
                    else torch.cat([a.to(dev) for a in ls]), *parts)


def _mesh_batch(B: int, mesh) -> int:
    """Pad the instance count to a multiple of the mesh's "data" axis so
    every shard carries an equal slice; the pad rows are *born-done* dummy
    instances (zero data, zero budget) that never join a dispatch's active
    set and accrue nothing."""
    if mesh is None:
        return B
    return _round_up(B, int(mesh.shape["data"]))


def _born_done(state_np: Dict[str, np.ndarray], B: int):
    """Mark the mesh padding rows past the B real instances finished."""
    state_np["done"][B:] = True
    return state_np


def _packed(record, data_np, state_np, comm_np, mesh, device):
    """The packed ``(data, state0)``: on ``device``, or split over ``mesh``
    (whose devices then take its place)."""
    if mesh is not None:
        return (device_put_sharded(EngineData(*data_np), mesh),
                device_put_sharded(record(comm=BatchCommLog(*comm_np),
                                          **state_np), mesh))
    dev = _device.resolve(device)
    return (EngineData(*(torch.from_numpy(a).to(dev) for a in data_np)),
            _state_to(state_np, comm_np, dev, record))


def transcript_capacity(k: int, max_epochs: int) -> int:
    """Static per-node transcript bound.  Per epoch a node appends at most
    ``8k - 4`` rows: one coordinator turn (its own ≤2 band points, ≤2 extreme
    points from each of k-1 repliers, a 2-point pivot pair) plus k-1
    non-coordinator turns (≤2 received band points, its own ≤2 extremes,
    a 2-point pivot pair).  +8 slack keeps the 2-row block writes in bounds.
    """
    return _round_up(max_epochs * (8 * k - 4) + 8, 8)


def _state_to(state_np: Dict[str, np.ndarray], comm_np, dev,
              record=ProtocolState):
    leaves = {f: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
              for f, a in state_np.items()}
    comm = BatchCommLog(*(torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                          for a in comm_np))
    return record(comm=comm, **leaves)


def _pack_shards(instances, d: int, B: Optional[int] = None):
    """The (X, y, budget) numpy arrays of a sweep: shards padded to n_max
    (rounded up to 8) with label-0 rows, budget = floor(ε · n_total); ``B``
    (default: the instance count) adds all-zero rows past the instances."""
    k = len(instances[0].shards)
    B = len(instances) if B is None else B
    n_max = _round_up(max(s[0].shape[0] for inst in instances
                          for s in inst.shards), 8)
    X = np.zeros((B, k, n_max, d), np.float32)
    y = np.zeros((B, k, n_max), np.int32)
    budget = np.zeros((B,), np.int32)
    for b, inst in enumerate(instances):
        n_total = 0
        for j, (Xs, ys) in enumerate(inst.shards):
            n = Xs.shape[0]
            if not (np.abs(ys) == 1).all():
                raise ValueError("labels must be +-1")
            X[b, j, :n] = Xs
            y[b, j, :n] = ys
            n_total += n
        budget[b] = int(np.floor(inst.eps * n_total))
    return X, y, budget


def _shared_k_d(instances):
    if not instances:
        raise ValueError("need at least one instance")
    ks = {len(inst.shards) for inst in instances}
    if len(ks) != 1:
        raise ValueError(f"instances must share the party count, got {ks}")
    ds = {s[0].shape[1] for inst in instances for s in inst.shards}
    return ks.pop(), ds


def pack_instances(
    instances: Sequence[ProtocolInstance],
    *,
    n_angles: int,
    max_epochs: int,
    mesh=None,
    device="cuda",
) -> Tuple[EngineData, ProtocolState, int, int]:
    """Pad a sweep onto the engine's static shapes, on ``device``.

    Returns ``(data, state0, k, cap)``.  All instances must share the party
    count k and dimension d=2; shard sizes may be ragged (label-0 padding).
    ``n_max`` and ``cap`` are rounded up to multiples of 8.  The arrays are
    built in numpy exactly as the JAX package builds them and uploaded
    once.  With ``mesh`` the batch pads to a multiple of the data-axis size
    with born-done dummy rows and uploads born-sharded
    (:func:`device_put_sharded`; ``data`` and ``state0`` are then tuples of
    per-shard records).
    """
    k, ds = _shared_k_d(instances)
    if ds != {2}:
        raise ValueError(f"MEDIAN engine is specified for R^2, got d={ds}")
    B = _mesh_batch(len(instances), mesh)
    cap = transcript_capacity(k, max_epochs)
    data, state0 = _packed(
        ProtocolState, _pack_shards(instances, 2, B),
        _born_done(_median_state0(B, k, cap, n_angles), len(instances)),
        [np.zeros((B,), np.int32) for _ in BatchCommLog._fields],
        mesh, device)
    return data, state0, k, cap


def _median_state0(B: int, k: int, cap: int, m: int):
    return dict(
        dir_ok=np.ones((B, m), bool),
        wx=np.zeros((B, k, cap, 2), np.float32),
        wy=np.zeros((B, k, cap), np.int32),
        w_fill=np.zeros((B, k), np.int32),
        lo_w=np.full((B, k, m), -np.inf, np.float32),
        hi_w=np.full((B, k, m), np.inf, np.float32),
        turn=np.zeros((B,), np.int32),
        done=np.zeros((B,), bool),
        converged=np.zeros((B,), bool),
        epochs=np.zeros((B,), np.int32),
        h_v=np.zeros((B, 2), np.float32),
        h_t=np.zeros((B,), np.float32),
        h_valid=np.zeros((B,), bool),
    )


def maxmarg_transcript_capacity(k: int, max_epochs: int,
                                max_support: int) -> int:
    """Static per-node transcript bound for the MAXMARG selector.  Per epoch
    a node *receives* at most ``max_support`` points on each of the k-1
    turns where it is not coordinator, plus (as coordinator) a 2-point
    violation reply from each of the k-1 others: ``(max_support + 2)(k-1)``
    rows.  +8 slack keeps every block write (≤ 8 rows, at the fill) inside
    the buffer; the appends assert it."""
    if not 1 <= max_support <= 8:
        raise ValueError(
            f"max_support must be in [1, 8] (block appends write at most 8 "
            f"rows past the fill), got {max_support}")
    return _round_up(max_epochs * (max_support + 2) * (k - 1) + 8, 8)


def _maxmarg_state0(B: int, k: int, cap: int, d: int):
    return dict(
        wx=np.zeros((B, k, cap, d), np.float32),
        wy=np.zeros((B, k, cap), np.int32),
        w_fill=np.zeros((B, k), np.int32),
        turn=np.zeros((B,), np.int32),
        done=np.zeros((B,), bool),
        converged=np.zeros((B,), bool),
        epochs=np.zeros((B,), np.int32),
        h_w=np.zeros((B, d), np.float32),
        h_b=np.zeros((B,), np.float32),
        h_valid=np.zeros((B,), bool),
        warm_turn=np.zeros((B,), bool),
        c_w=np.zeros((B, k, d), np.float32),
        c_b=np.zeros((B, k), np.float32),
        c_valid=np.zeros((B, k), bool),
        warm_node=np.zeros((B, k), bool),
        latches=np.zeros((B,), np.int32),
    )


def pack_instances_maxmarg(
    instances: Sequence[ProtocolInstance],
    *,
    max_epochs: int,
    max_support: int,
    mesh=None,
    device="cuda",
) -> Tuple[EngineData, MaxMargState, int, int]:
    """Pad a MAXMARG sweep onto the engine's static shapes, on ``device``.

    Returns ``(data, state0, k, cap)``.  All instances must share the party
    count k and the dimension d (any d — MAXMARG has no direction grid);
    shard sizes may be ragged (label-0 padding).  ``n_max`` and ``cap`` are
    rounded up to multiples of 8; the arrays are built in numpy exactly as
    the JAX package builds them and uploaded once.  With ``mesh`` the batch
    pads to a multiple of the data-axis size with born-done dummy rows and
    uploads born-sharded (:func:`device_put_sharded`).
    """
    k, ds = _shared_k_d(instances)
    if len(ds) != 1:
        raise ValueError(f"instances must share the dimension, got {ds}")
    d = ds.pop()
    B = _mesh_batch(len(instances), mesh)
    cap = maxmarg_transcript_capacity(k, max_epochs, max_support)
    data, state0 = _packed(
        MaxMargState, _pack_shards(instances, d, B),
        _born_done(_maxmarg_state0(B, k, cap, d), len(instances)),
        [np.zeros((B,), np.int32) for _ in BatchCommLog._fields],
        mesh, device)
    return data, state0, k, cap


class UnifiedState(NamedTuple):
    """Superset state of a mixed-selector dispatch: the union of
    :class:`ProtocolState`, :class:`MaxMargState` and the one-way sampling
    chain's reservoir carry, keyed by a per-instance selector code ``sel``
    (``SEL_MEDIAN`` / ``SEL_MAXMARG`` / ``SEL_SAMPLING``).

    * the transcripts ``wx``/``wy``/``w_fill`` are shared; a SAMPLING row
      keeps its Vitter reservoir in node ``k-1``'s transcript, so the
      terminal fit over shard ``k-1`` ∪ that transcript is the sampling
      oracle's own ∪ reservoir fit;
    * the separator ``h_w``/``h_b``/``h_valid`` is shared; a MEDIAN row
      keeps its direction in ``h_w`` and its threshold in ``h_b``;
    * the control leaves are shared and per-instance;
    * selector-private leaves pass untouched through the other families'
      substeps: the MEDIAN arc (``dir_ok``/``lo_w``/``hi_w``, 1 wide when
      the mix has no MEDIAN row), the MAXMARG warm carries, and the
      sampling counters (``seen``/``res_cap``/``hop_keys``).

    ``hop_keys`` holds Threefry words in int64, as every key of the port
    (:mod:`repro_torch.core.prng`); the JAX package keeps them uint32.
    """

    sel: torch.Tensor        # (B,) i32 — SEL_* code per instance
    dir_ok: torch.Tensor     # (B, m) bool — allowed direction arc
    lo_w: torch.Tensor       # (B, k, m) f32 — running per-node threshold lo
    hi_w: torch.Tensor       # (B, k, m) f32 — running per-node threshold hi
    wx: torch.Tensor         # (B, k, cap, d) f32 — transcripts / reservoir
    wy: torch.Tensor         # (B, k, cap) i32 — labels (0 = empty)
    w_fill: torch.Tensor     # (B, k) i32 — fill counters
    turn: torch.Tensor       # (B,) i32 — per-instance turn counter
    done: torch.Tensor       # (B,) bool
    converged: torch.Tensor  # (B,) bool
    epochs: torch.Tensor     # (B,) i32
    h_w: torch.Tensor        # (B, d) f32 — separator (MEDIAN: h_v)
    h_b: torch.Tensor        # (B,) f32 — offset (MEDIAN: h_t)
    h_valid: torch.Tensor    # (B,) bool
    warm_turn: torch.Tensor  # (B,) bool — MAXMARG warm carries
    c_w: torch.Tensor        # (B, k, d) f32
    c_b: torch.Tensor        # (B, k) f32
    c_valid: torch.Tensor    # (B, k) bool
    warm_node: torch.Tensor  # (B, k) bool
    latches: torch.Tensor    # (B,) i32
    seen: torch.Tensor       # (B,) i32 — valid stream rows ingested so far
    res_cap: torch.Tensor    # (B,) i32 — per-instance ε-net reservoir size
    hop_keys: torch.Tensor   # (B, max(k-1, 1), 2) int64 — Vitter hop keys
    comm: BatchCommLog


def unified_transcript_capacity(k: int, max_epochs: int, max_support: int,
                                res_cap: int = 0,
                                has_median: bool = True) -> int:
    """Shared transcript bound of a mixed sweep: the largest of each
    family's own (:func:`transcript_capacity` for MEDIAN,
    :func:`maxmarg_transcript_capacity` for MAXMARG, the largest ε-net
    reservoir for SAMPLING), a multiple of 8."""
    cap = maxmarg_transcript_capacity(k, max_epochs, max_support)
    if has_median:
        cap = max(cap, transcript_capacity(k, max_epochs))
    return max(cap, _round_up(max(res_cap, 0), 8))


def _unified_state0(sels: Sequence[str], k: int, cap: int, d: int, m: int,
                    res_cap: np.ndarray, seeds: Sequence[int],
                    done: Optional[np.ndarray] = None):
    """Fresh superset leaves (numpy) for instances of the given families;
    SAMPLING rows get their reservoir sizes and their hop keys,
    ``jax.random.split(jax.random.PRNGKey(seed), k-1)`` as int64 words."""
    B = len(res_cap)
    hop_keys = np.zeros((B, max(k - 1, 1), 2), np.int64)
    samp = [i for i, s in enumerate(sels) if s == "sampling"]
    if samp and k > 1:
        hop_keys[samp] = prng.split(
            prng.prng_key([seeds[i] for i in samp]), k - 1).numpy()
    sel = np.zeros((B,), np.int32)
    sel[:len(sels)] = [SELECTOR_CODES[s] for s in sels]
    return dict(
        sel=sel,
        dir_ok=np.ones((B, m), bool),
        lo_w=np.full((B, k, m), -np.inf, np.float32),
        hi_w=np.full((B, k, m), np.inf, np.float32),
        wx=np.zeros((B, k, cap, d), np.float32),
        wy=np.zeros((B, k, cap), np.int32),
        w_fill=np.zeros((B, k), np.int32),
        turn=np.zeros((B,), np.int32),
        done=np.zeros((B,), bool) if done is None else done,
        converged=np.zeros((B,), bool),
        epochs=np.zeros((B,), np.int32),
        h_w=np.zeros((B, d), np.float32),
        h_b=np.zeros((B,), np.float32),
        h_valid=np.zeros((B,), bool),
        warm_turn=np.zeros((B,), bool),
        c_w=np.zeros((B, k, d), np.float32),
        c_b=np.zeros((B, k), np.float32),
        c_valid=np.zeros((B, k), bool),
        warm_node=np.zeros((B, k), bool),
        latches=np.zeros((B,), np.int32),
        seen=np.zeros((B,), np.int32),
        res_cap=res_cap.astype(np.int32),
        hop_keys=hop_keys,
    )


def pack_instances_unified(
    instances: Sequence[ProtocolInstance],
    *,
    n_angles: int,
    max_epochs: int,
    max_support: int,
    vc_dim: Optional[int] = None,
    c: Optional[float] = None,
    device="cuda",
) -> Tuple[EngineData, UnifiedState, int, int]:
    """Pad a mixed MEDIAN + MAXMARG + SAMPLING sweep onto one static shape,
    on ``device``.

    Returns ``(data, state0, k, cap)``.  All instances must share k and d;
    a MEDIAN instance requires d=2 and sizes the arc leaves to
    ``n_angles`` (a median-free mix carries 1-wide stub arcs).  SAMPLING
    rows get their ε-net size in ``res_cap`` (``vc_dim`` default d+1,
    ``c`` default ``EPSILON_NET_C``, as the one-way sweep) and their hop
    keys split from ``ProtocolInstance.seed``, so each reservoir is the
    one-way oracle's, row for row.
    """
    dev = _device.resolve(device)
    k, ds = _shared_k_d(instances)
    if len(ds) != 1:
        raise ValueError(f"instances must share the dimension, got {ds}")
    d = ds.pop()
    sels = [inst.selector for inst in instances]
    unknown = set(sels) - set(SELECTOR_CODES)
    if unknown:
        raise ValueError(
            f"unified packing covers {sorted(SELECTOR_CODES)}, got "
            f"{sorted(unknown)}")
    has_median = "median" in sels
    if has_median and d != 2:
        raise ValueError(f"MEDIAN instances require d=2, got d={d}")
    m = n_angles if has_median else 1
    vc = vc_dim if vc_dim is not None else d + 1
    cc = c if c is not None else EPSILON_NET_C
    res_cap = np.asarray([epsilon_net_size(inst.eps, vc, c=cc)
                          if inst.selector == "sampling" else 0
                          for inst in instances], np.int32)
    cap = unified_transcript_capacity(k, max_epochs, max_support,
                                      res_cap=int(res_cap.max()),
                                      has_median=has_median)
    X, y, budget = _pack_shards(instances, d)
    data = EngineData(*(torch.from_numpy(a).to(dev) for a in (X, y, budget)))
    B = len(instances)
    state0 = _state_to(
        _unified_state0(sels, k, cap, d, m, res_cap,
                        [inst.seed for inst in instances]),
        [np.zeros((B,), np.int32) for _ in BatchCommLog._fields], dev,
        UnifiedState)
    return data, state0, k, cap


def from_reference(data, state, V=None, device="cuda"):
    """Carry the JAX package's packed sweep across: ``data`` an
    ``EngineData`` and ``state`` a MEDIAN ``ProtocolState`` or a
    ``UnifiedState``, each with ``V`` its (m, d) direction grid (the (1, d)
    stub of a median-free mix), or a ``MaxMargState`` (no ``V``), each leaf
    anything ``np.asarray`` accepts.  Returns the port's ``(EngineData,
    state, V)`` on ``device`` (``V`` None for MAXMARG), leaf for leaf, bit
    for bit — this system's "weights" are its packed state, and the tests
    run both packages on identical inputs.  The uint32 ``hop_keys`` of a
    unified state become the port's int64 words, equal in value."""
    dev = _device.resolve(device)
    fields = tuple(f for f in type(state)._fields if f != "comm")
    record = {tuple(f for f in r._fields if f != "comm"): r
              for r in (ProtocolState, MaxMargState,
                        UnifiedState)}.get(fields)
    if record is None:
        raise TypeError(f"from_reference takes a ProtocolState, a "
                        f"MaxMargState or a UnifiedState, got "
                        f"{type(state).__name__}")
    if (record is MaxMargState) == (V is not None):
        raise ValueError("a MEDIAN or unified state comes with its "
                         "direction grid V, a MAXMARG state without one")
    data_t = EngineData(*(torch.from_numpy(np.array(a)).to(dev)
                          for a in data))
    leaves = {f: np.array(getattr(state, f)) for f in fields}
    if record is UnifiedState:
        leaves["hop_keys"] = leaves["hop_keys"].astype(np.int64)
    state_t = _state_to(leaves, [np.array(a) for a in state.comm], dev,
                        record)
    V_t = (None if V is None
           else torch.from_numpy(np.array(V, dtype=np.float32)).to(dev))
    return data_t, state_t, V_t
