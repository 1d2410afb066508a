"""Fault-tolerant streaming session pool over the hot loop's compacted turn
(counterpart of ``repro.engine.session_pool``).

A ring buffer of W session slots: slots freed by converged or evicted
sessions refill from a pending queue between turns, and one dispatch
advances every live slot whatever its protocol phase (the coordinator
index ``ci = turn % k`` is per-instance).  ``PoolConfig(selector=
"unified")`` admits interleaved MEDIAN + MAXMARG + SAMPLING sessions into
one slot array over :class:`~repro_torch.engine.state.UnifiedState`
(:mod:`repro_torch.engine.unified`).

**Bit-exactness per session.**  The pool's contract, as in the JAX
package: chaos runs equal fault-free runs, a restored pool equals an
uninterrupted one, and every admission order gives the same results, bit
for bit.  The JAX pool gets it from one pinned compile key.  Here every
turn launches the same kernels at the same shapes whatever the batch
holds: the dispatch always gathers the full ``round_up(slots, 4)`` block
at the full ``cap`` width; the kernel flags and ``solver_kernel`` are
resolved once, at construction (on for a CUDA device: the MEDIAN cut and
extremes scans, the MAXMARG turn scan and the Pegasos stage); and no
operation's result for one row depends on the other rows or on the live
count.  That one launch shape goes into ``hotloop.KEY_LOG`` every turn.
The JAX package scatters blocks whose tail holds the out-of-range index W
and lets XLA drop those rows; torch would raise, so admission, corruption
and the done-marks of eviction scatter only their live prefix (a Python
int), as ``hotloop.take_instances``/``put_instances`` do.

**Failure model** (:mod:`repro_torch.engine.faults`, a verbatim copy of
the JAX package's): a seeded stateless schedule injects per-turn node
dropouts and lost messages (the turn aborts before dispatch and retries
under exponential backoff, bounded by ``retry_budget``), stragglers (the
session sits out a drawn number of pool turns, no retry charged), and
post-turn state corruption.  Every live slot is screened each turn
against three invariants, from one (5, W) supervision view: NaN
separator, non-monotone transcript fill, comm-budget blowout.  A tripped
invariant or an exhausted retry budget quarantines the session, which is
then evicted with its counters surfaced.

**Checkpoint/restore** writes the JAX package's format: one flat-key
``.npz`` (``data/.X``, ``state/.wx``, ``state/.comm/.points``, ``host/...``,
``pending/...``, the hop keys as uint32 words) and a ``latest.json``
manifest, so either package's pool restores the other's checkpoint.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import os
from collections import deque
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import _device
from repro_torch.core.sampling import epsilon_net_size
from repro_torch.engine import dataplane, hotloop, maxmarg, median, unified
from repro_torch.engine import faults as F
from repro_torch.engine.state import (
    BatchCommLog,
    EngineData,
    MaxMargState,
    ProtocolState,
    SEL_MEDIAN,
    SELECTOR_CODES,
    SELECTOR_NAMES,
    UnifiedState,
    _maxmarg_state0,
    _median_state0,
    _round_up,
    _state_to,
    _unified_state0,
    maxmarg_transcript_capacity,
    transcript_capacity,
    unified_transcript_capacity,
)

# host-side slot lifecycle (the device only ever sees done flags)
SLOT_EMPTY = 0
SLOT_LIVE = 1
SLOT_QUARANTINED = 2

# terminal session statuses in the ledger
ST_PENDING = "pending"
ST_LIVE = "live"
ST_CONVERGED = "converged"
ST_BUDGET = "budget_exhausted"
ST_QUARANTINED = "quarantined"

_I32 = torch.int32


@dataclasses.dataclass(frozen=True)
class PoolConfig:
    """Static pool geometry and supervision policy, field for field the JAX
    package's (so a manifest written by either package restores in the
    other's config).

    ``slots`` (the ring width W), ``k``/``n_pad``/``d`` (the shared
    instance shapes every admitted session is padded to with label-0
    rows), the epoch budget and the ``admit_block``/``corrupt_block``
    widths fix every launch shape of the pool.  A turn must complete
    within one pool turn; a miss (dropout, lost message) retries after
    ``backoff_base * 2**(retries-1)`` pool turns and quarantines when the
    consecutive-retry count exceeds ``retry_budget``.  ``comm_limit_bits``
    is the comm-blowout threshold.  ``selector="unified"`` takes any
    family per :meth:`SessionPool.submit`; ``res_cap`` is the largest
    SAMPLING reservoir it accepts (default: the ε-net size at ``eps``).
    ``solver_kernel`` None takes the Pegasos kernel on a CUDA device and
    the classic loop on the CPU, resolved once at construction.  The
    device is an argument of the pool, not a field.
    """

    slots: int
    k: int
    n_pad: int
    d: int = 2
    selector: str = "median"
    eps: float = 0.05
    n_angles: int = 256
    max_epochs: int = 16
    max_support: int = 4
    svm_steps: int = 2000
    svm_stages: int = 3
    lam0: float = 1e-3
    solver_kernel: Optional[bool] = None
    res_cap: Optional[int] = None
    admit_block: int = 8
    corrupt_block: int = 4
    retry_budget: int = 3
    backoff_base: int = 1
    comm_limit_bits: int = 1 << 16
    checkpoint_every: int = 0            # pool turns between snapshots; 0=off
    checkpoint_dir: Optional[str] = None

    def __post_init__(self):
        if self.selector not in ("median", "maxmarg", "unified"):
            raise ValueError(f"unknown selector {self.selector!r}")
        if self.selector == "median" and self.d != 2:
            raise ValueError("MEDIAN engine is specified for R^2")
        if self.selector == "unified" and self.res_cap is None:
            # resolved once so dataclasses.asdict round-trips the pinned cap
            object.__setattr__(self, "res_cap", _round_up(
                epsilon_net_size(self.eps, self.d + 1), 8))
        if self.n_pad % 8:
            object.__setattr__(self, "n_pad", _round_up(self.n_pad, 8))
        if self.slots < 1 or self.k < 2:
            raise ValueError("need slots >= 1 and k >= 2")
        if self.checkpoint_every and not self.checkpoint_dir:
            raise ValueError("checkpoint_every needs checkpoint_dir")

    @property
    def max_turns(self) -> int:
        return self.k * self.max_epochs

    @property
    def cap(self) -> int:
        if self.selector == "median":
            return transcript_capacity(self.k, self.max_epochs)
        if self.selector == "unified":
            return unified_transcript_capacity(
                self.k, self.max_epochs, self.max_support,
                res_cap=int(self.res_cap or 0), has_median=(self.d == 2))
        return maxmarg_transcript_capacity(self.k, self.max_epochs,
                                           self.max_support)


# ---------------------------------------------------------------------------
# device operations: admission, corruption, supervision view, done-marks
# ---------------------------------------------------------------------------


def _admit_rows(data, state, idx: torch.Tensor, dblk, sblk, n: int):
    """Scatter the live prefix ``n`` of an admission block (the fresh (A,
    ...) data and state rows ``dblk``/``sblk``) into the pool's records at
    the slots ``idx[:n]``, in place."""
    return (hotloop.put_instances(data, dblk, idx, n),
            hotloop.put_instances(state, sblk, idx, n))


def _slot_masks(W: int, idx: np.ndarray, kind: np.ndarray, device):
    """The (3, W) bool masks of a corruption block: NaN, fill and comm
    kinds at their slots (the block's tail, index W, is dropped)."""
    masks = np.zeros((3, W), bool)
    live = idx < W
    for r, kv in enumerate((F.CORRUPT_NAN, F.CORRUPT_FILL, F.CORRUPT_COMM)):
        masks[r, idx[live]] = kind[live] == kv
    return torch.from_numpy(masks).to(device)


def _corrupt_common(state, masks: torch.Tensor, w_name: str, b_name: str):
    m_nan, m_fill, m_comm = masks
    spike = torch.where(m_comm, F.COMM_SPIKE_BITS, 0).to(_I32)
    return state._replace(**{
        b_name: torch.where(m_nan, torch.nan, getattr(state, b_name)),
        w_name: torch.where(m_nan[:, None], torch.nan,
                            getattr(state, w_name)),
        "w_fill": torch.where(m_fill[:, None], 0, state.w_fill),
        "comm": state.comm._replace(bits=state.comm.bits + spike),
    })


def _corrupt_median(state: ProtocolState, masks) -> ProtocolState:
    """Apply drawn corruption kinds (masks from :func:`_slot_masks`): each
    trips exactly one supervisor invariant — NaN separator, zeroed
    (non-monotone) fills, or a comm-bit spike.  Runs after the turn's
    dispatch: delivered messages were metered; only the victim's own
    state mutates."""
    return _corrupt_common(state, masks, "h_v", "h_t")


def _corrupt_maxmarg(state: MaxMargState, masks) -> MaxMargState:
    return _corrupt_common(state, masks, "h_w", "h_b")


# UnifiedState shares MaxMargState's separator, transcript and comm leaf
# names, so the MAXMARG corruption and view apply verbatim.  The view's
# max fill is each family's actual transcript fill (a SAMPLING row's
# reservoir fill, min(seen, res_cap), grows with every hop).
_corrupt_unified = _corrupt_maxmarg


def _view(state, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    nan = torch.isnan(b) | torch.isnan(w).any(dim=1)
    return torch.stack([state.done.to(_I32), state.converged.to(_I32),
                        state.w_fill.amax(dim=1), nan.to(_I32),
                        state.comm.bits])


def _view_median(state: ProtocolState) -> torch.Tensor:
    """Supervision view as one (5, W) i32 tensor: done, converged, max
    transcript fill, NaN-separator flag, comm bits."""
    return _view(state, state.h_v, state.h_t)


def _view_maxmarg(state: MaxMargState) -> torch.Tensor:
    return _view(state, state.h_w, state.h_b)


_view_unified = _view_maxmarg


def _mark_done(state, slots: np.ndarray):
    """Pin freed slots done on the device, in place."""
    idx = torch.from_numpy(np.asarray(slots, np.int64)).to(state.done.device)
    state.done.index_fill_(0, idx, True)
    state.converged.index_fill_(0, idx, False)
    return state


# ---------------------------------------------------------------------------
# fresh-row templates (host numpy, uploaded on admission)
# ---------------------------------------------------------------------------


def _born_done(A: int, live: int) -> np.ndarray:
    done = np.zeros((A,), bool)
    done[live:] = True                    # block padding rows are born done
    return done


def _fresh_state_median(A: int, cfg: PoolConfig, live: int):
    leaves = _median_state0(A, cfg.k, cfg.cap, cfg.n_angles)
    leaves["done"] = _born_done(A, live)
    return ProtocolState, leaves


def _fresh_state_maxmarg(A: int, cfg: PoolConfig, live: int):
    leaves = _maxmarg_state0(A, cfg.k, cfg.cap, cfg.d)
    leaves["done"] = _born_done(A, live)
    return MaxMargState, leaves


def _fresh_state_unified(A: int, cfg: PoolConfig, live: int,
                         batch: Sequence["_Pending"] = ()):
    """Fresh superset rows for a mixed admission wave: the selector code,
    reservoir size and Vitter hop keys are per-row data from the pending
    entries; the shapes never depend on the wave's mix."""
    m = cfg.n_angles if cfg.d == 2 else 1
    res_cap = np.zeros((A,), np.int32)
    res_cap[:len(batch)] = [p.res_cap for p in batch]
    return UnifiedState, _unified_state0(
        [p.selector for p in batch], cfg.k, cfg.cap, cfg.d, m, res_cap,
        [p.seed for p in batch], done=_born_done(A, live))


def _upload(fresh, A: int, device):
    record, leaves = fresh
    return _state_to(leaves, [np.zeros((A,), np.int32)
                              for _ in BatchCommLog._fields], device, record)


# ---------------------------------------------------------------------------
# flat checkpoint keys (the JAX package's ``train.checkpoint._flatten``)
# ---------------------------------------------------------------------------


def _flat_items(tree, prefix: str):
    """(key, leaf) pairs of a record of tensors (or a dict of records),
    keyed as the JAX package's flat checkpoints: ``prefix/.field``, a
    nested record's leaves ``prefix/.field/.leaf``, a dict's entries
    ``prefix/name``."""
    if isinstance(tree, dict):
        for name, sub in tree.items():
            yield from _flat_items(sub, f"{prefix}/{name}" if prefix
                                   else name)
    elif isinstance(tree, tuple):
        for name, sub in zip(tree._fields, tree):
            yield from _flat_items(sub, f"{prefix}/.{name}")
    else:
        yield prefix, tree


def _flatten(tree) -> Dict[str, np.ndarray]:
    return {key: leaf.cpu().numpy() for key, leaf in _flat_items(tree, "")}


def _unflatten(like, z, prefix: str):
    """A record shaped as ``like`` (tensors on its device) from the flat
    ``.npz`` ``z``, each leaf cast to ``like``'s dtype (the JAX package's
    uint32 keys become int64 words, equal in value)."""
    if isinstance(like, tuple):
        return type(like)(*(_unflatten(sub, z, f"{prefix}/.{name}")
                            for name, sub in zip(like._fields, like)))
    host = np.asarray(z[prefix]).astype(
        torch.empty((), dtype=like.dtype).numpy().dtype)
    return torch.from_numpy(host).to(like.device)


@dataclasses.dataclass
class _Pending:
    sid: int
    X: np.ndarray        # (k, n_pad, d) f32
    y: np.ndarray        # (k, n_pad) i32
    budget: int
    selector: str = "median"   # per-session family (unified pools)
    seed: int = 0              # Vitter PRNG seed (SAMPLING sessions)
    res_cap: int = 0           # ε-net reservoir rows (SAMPLING sessions)


class SessionPool:
    """Ring-buffer session pool on ``device``: streaming admission over the
    hot loop's compacted turn, seeded fault injection, host-side
    supervision, checkpoint/restore.

    ::

        pool = SessionPool(PoolConfig(slots=32, k=2, n_pad=64),
                           schedule=FaultSchedule(seed=7, p_dropout=0.05),
                           device="cuda")
        sids = [pool.submit(shards) for shards in workload]
        pool.run()
        results = pool.results          # sid -> ProtocolResult
        pool.session(sid)["retries"]    # per-session supervision counters

    Every supervision decision is a pure function of the host arrays, the
    device view and the fault schedule, so two pools with equal config,
    schedule and workload decide alike, across :meth:`checkpoint` /
    :meth:`restore` too.  Launch-shape contract: every shape is fixed at
    construction — ``PoolConfig``'s geometry, ``cap``, the solver
    options, the resolved kernel flags — and each turn dispatches at the
    one shape ``(round_up(slots, 4), cap, False, False)`` that it appends
    to ``hotloop.KEY_LOG``; nothing a caller streams (session count,
    admission order, selector mix, ε, seeds, fault timing) changes it.
    """

    def __init__(self, config: PoolConfig,
                 schedule: Optional[F.FaultSchedule] = None,
                 stats: Optional[dict] = None, device="cuda"):
        self.cfg = config
        self.device = _device.resolve(device)
        self.schedule = schedule if schedule is not None else F.FaultSchedule()
        self.stats: Dict[str, Any] = stats if stats is not None else {}
        # resolved once: the launched kernels are part of the pinned shape
        on_card = dataplane.use_kernels_default(self.device)
        self._kernels = on_card
        self._solver_kernel = (on_card if config.solver_kernel is None
                               else bool(config.solver_kernel))
        W, k, n_pad, d = config.slots, config.k, config.n_pad, config.d
        dev = self.device

        if config.selector == "median" or (config.selector == "unified"
                                           and d == 2):
            from repro_torch.core import geometry as geo
            self._V = geo.direction_grid(config.n_angles, device=dev)
        elif config.selector == "unified":   # median-free pool: stub grid
            self._V = torch.zeros((1, d), dtype=torch.float32, device=dev)
        else:
            self._V = None
        self.data = EngineData(
            torch.zeros((W, k, n_pad, d), dtype=torch.float32, device=dev),
            torch.zeros((W, k, n_pad), dtype=_I32, device=dev),
            torch.zeros((W,), dtype=_I32, device=dev))
        # empty slots are born done: inert even if gathered as padding
        self.state = _upload(self._fresh(W, 0), W, dev)

        self.pool_turn = 0
        self._next_sid = 0
        self.pending: deque = deque()
        self.sessions: Dict[int, Dict[str, Any]] = {}
        self.results: Dict[int, Any] = {}

        # host supervision arrays (one row per slot)
        self.sid = np.full((W,), -1, np.int64)
        self.slot_state = np.full((W,), SLOT_EMPTY, np.int32)
        self.retries = np.zeros((W,), np.int32)       # consecutive, current
        self.backoff_until = np.zeros((W,), np.int64)
        self.straggle_until = np.zeros((W,), np.int64)
        self.prev_fill = np.zeros((W,), np.int32)
        self.turns_done = np.zeros((W,), np.int32)
        self.slot_sel = np.zeros((W,), np.int32)   # SEL_* code per slot

        for key in ("admitted", "evicted_converged", "evicted_budget",
                    "quarantined", "dispatches", "pool_turns",
                    "retries_total", "backoffs_total", "dropouts",
                    "drop_msgs", "straggles", "corruptions"):
            self.stats.setdefault(key, 0)

    def _fresh(self, A: int, live: int, batch: Sequence[_Pending] = ()):
        cfg = self.cfg
        if cfg.selector == "median":
            return _fresh_state_median(A, cfg, live)
        if cfg.selector == "unified":
            return _fresh_state_unified(A, cfg, live, batch)
        return _fresh_state_maxmarg(A, cfg, live)

    # -- submission ---------------------------------------------------------

    def submit(self, shards: Sequence[Tuple[np.ndarray, np.ndarray]],
               eps: Optional[float] = None,
               selector: Optional[str] = None, seed: int = 0) -> int:
        """Queue one protocol instance (k ragged shards, padded here to the
        pool's (k, n_pad, d)).  Returns the session id.

        ``selector`` picks the session's family on unified pools (default:
        MEDIAN when d=2, else MAXMARG); per-selector pools accept only
        their own.  ``seed`` feeds a SAMPLING session's Vitter chain, whose
        ε-net reservoir (from ``eps``) must fit the pool's ``res_cap``.
        Neither changes a launch shape."""
        cfg = self.cfg
        if selector is None:
            selector = (cfg.selector if cfg.selector != "unified"
                        else ("median" if cfg.d == 2 else "maxmarg"))
        if cfg.selector == "unified":
            if selector not in SELECTOR_CODES:
                raise ValueError(
                    f"unified pools take {sorted(SELECTOR_CODES)}, "
                    f"got {selector!r}")
            if selector == "median" and cfg.d != 2:
                raise ValueError("MEDIAN sessions require a d=2 pool")
        elif selector != cfg.selector:
            raise ValueError(
                f"pool is pinned to selector {cfg.selector!r}; "
                f"mixed traffic needs PoolConfig(selector='unified')")
        if len(shards) != cfg.k:
            raise ValueError(f"expected {cfg.k} shards, got {len(shards)}")
        X = np.zeros((cfg.k, cfg.n_pad, cfg.d), np.float32)
        y = np.zeros((cfg.k, cfg.n_pad), np.int32)
        n_total = 0
        for j, (Xs, ys) in enumerate(shards):
            Xs = np.asarray(Xs)
            ys = np.asarray(ys)
            n = Xs.shape[0]
            if n > cfg.n_pad:
                raise ValueError(
                    f"shard {j} has {n} rows > pinned n_pad={cfg.n_pad}")
            if Xs.shape[1] != cfg.d:
                raise ValueError(f"shard {j} is d={Xs.shape[1]}, "
                                 f"pool is d={cfg.d}")
            if not (np.abs(ys) == 1).all():
                raise ValueError("labels must be +-1")
            X[j, :n] = Xs
            y[j, :n] = ys
            n_total += n
        eps_eff = cfg.eps if eps is None else eps
        budget = int(np.floor(eps_eff * n_total))
        res_cap = 0
        if selector == "sampling":
            res_cap = epsilon_net_size(eps_eff, cfg.d + 1)
            if res_cap > (cfg.res_cap or 0):
                raise ValueError(
                    f"SAMPLING session needs a {res_cap}-row reservoir, "
                    f"pool pins res_cap={cfg.res_cap} (lower eps at "
                    f"construction or raise PoolConfig.res_cap)")
        sid = self._next_sid
        self._next_sid += 1
        self.pending.append(_Pending(sid, X, y, budget,
                                     selector=selector, seed=seed,
                                     res_cap=res_cap))
        self.sessions[sid] = {
            "status": ST_PENDING, "selector": selector,
            "retries": 0, "backoffs": 0,
            "dropouts": 0, "drop_msgs": 0, "straggles": 0,
            "corrupt_kind": -1, "quarantine_reason": None,
            "admitted_turn": -1, "evicted_turn": -1, "turns": 0,
        }
        return sid

    def session(self, sid: int) -> Dict[str, Any]:
        return self.sessions[sid]

    # -- internals ----------------------------------------------------------

    def _admit(self):
        """Refill empty slots from the pending queue in FIFO order, in
        ``admit_block``-sized waves (the block's padding rows are born done
        and never land)."""
        cfg = self.cfg
        W, A = cfg.slots, cfg.admit_block
        free = np.flatnonzero(self.slot_state == SLOT_EMPTY)
        while self.pending and free.size:
            take = min(len(self.pending), free.size, A)
            batch = [self.pending.popleft() for _ in range(take)]
            slots = free[:take]
            free = free[take:]

            X = np.zeros((A, cfg.k, cfg.n_pad, cfg.d), np.float32)
            y = np.zeros((A, cfg.k, cfg.n_pad), np.int32)
            budget = np.zeros((A,), np.int32)
            X[:take] = np.stack([p.X for p in batch])
            y[:take] = np.stack([p.y for p in batch])
            budget[:take] = [p.budget for p in batch]
            dblk = EngineData(*(torch.from_numpy(a).to(self.device)
                                for a in (X, y, budget)))
            fresh = _upload(self._fresh(A, take, batch), A, self.device)
            idx = np.full((A,), W, np.int64)
            idx[:take] = slots
            self.data, self.state = _admit_rows(
                self.data, self.state, torch.from_numpy(idx).to(self.device),
                dblk, fresh, take)

            for p, s in zip(batch, slots):
                self.sid[s] = p.sid
                self.slot_sel[s] = SELECTOR_CODES[p.selector]
                self.slot_state[s] = SLOT_LIVE
                self.retries[s] = 0
                self.backoff_until[s] = 0
                self.straggle_until[s] = 0
                self.prev_fill[s] = 0
                self.turns_done[s] = 0
                rec = self.sessions[p.sid]
                rec["status"] = ST_LIVE
                rec["admitted_turn"] = self.pool_turn
                self.stats["admitted"] += 1

    def _dispatch(self, rows: np.ndarray):
        """One mixed-phase turn over the given slot rows, always at the
        pool's one launch shape: the full ``round_up(slots, 4)`` index
        block (the tail gathers padding rows that never land) and the full
        ``cap`` width, with the kernel flags fixed at construction.  Every
        turn of every session then runs the same launches at the same
        shapes, which makes the per-session results bit-exact across
        admission timing, batch composition, fault delays and
        checkpoint/restore."""
        cfg = self.cfg
        W = cfg.slots
        n_act = int(rows.size)
        n_pad = _round_up(W, hotloop.BATCH_MULT)
        idx = np.full((n_pad,), W, np.int64)
        idx[:n_act] = rows
        idx_t = torch.from_numpy(idx).to(self.device)
        width = cfg.cap
        kern = self._kernels
        hotloop.KEY_LOG.append((n_pad, width, False, False))
        if cfg.selector == "median":
            step = functools.partial(
                median.step, k=cfg.k, first_turn=False, cut_kernel=kern,
                extremes_kernel=kern, trans_width=width)
            self.state = hotloop.gathered_turn(
                lambda sub_data, sub: step(sub_data, self._V, sub),
                median._pad_fix, self.data, self.state, idx_t, n_act)
        elif cfg.selector == "unified":
            self.state = unified.hot_turn(
                self.data, self._V, self.state, idx_t, n_act, k=cfg.k,
                max_support=cfg.max_support, steps=cfg.svm_steps,
                stages=cfg.svm_stages, lam0=cfg.lam0, trans_width=width,
                warm=False, per_node=False, has_median=(cfg.d == 2),
                first_turn=False, cut_kernel=kern, extremes_kernel=kern,
                fused_kernel=kern, solver_kernel=self._solver_kernel)
        else:
            step = functools.partial(
                maxmarg.step, k=cfg.k, max_support=cfg.max_support,
                steps=cfg.svm_steps, stages=cfg.svm_stages, lam0=cfg.lam0,
                trans_width=width, warm=False, per_node=False,
                fused_kernel=kern, solver_kernel=self._solver_kernel)
            self.state = hotloop.gathered_turn(
                step, maxmarg._pad_fix, self.data, self.state, idx_t, n_act)
        self.stats["dispatches"] += 1

    def _corrupt(self, rows: np.ndarray, kinds: np.ndarray):
        """Post-turn corruption in ``corrupt_block``-sized waves."""
        C = self.cfg.corrupt_block
        W = self.cfg.slots
        fn = {"median": _corrupt_median, "maxmarg": _corrupt_maxmarg,
              "unified": _corrupt_unified}[self.cfg.selector]
        for off in range(0, rows.size, C):
            idx = np.full((C,), W, np.int64)
            knd = np.full((C,), -1, np.int32)
            chunk = slice(off, min(off + C, rows.size))
            take = rows[chunk].size
            idx[:take] = rows[chunk]
            knd[:take] = kinds[chunk]
            self.state = fn(self.state, _slot_masks(W, idx, knd, self.device))

    def _quarantine(self, slot: int, reason: str):
        self.slot_state[slot] = SLOT_QUARANTINED
        rec = self.sessions[self.sid[slot]]
        rec["status"] = ST_QUARANTINED
        rec["quarantine_reason"] = reason
        self.stats["quarantined"] += 1

    def _evict(self, slots: np.ndarray):
        """Free finished and quarantined slots, taking the results of the
        sessions that ended cleanly: one transfer of each small result leaf
        per eviction wave."""
        from repro_torch.core import classifiers as clf
        from repro_torch.core.protocols.one_way import ProtocolResult

        cfg = self.cfg
        s = self.state
        if cfg.selector == "median":
            w_np = -s.h_v.cpu().double().numpy()
            b_np = s.h_t.cpu().double().numpy()
        else:
            w_np = s.h_w.cpu().double().numpy()
            b_np = s.h_b.cpu().double().numpy()
            if cfg.selector == "unified":
                # shared-leaf convention: a MEDIAN row keeps h_v in h_w
                w_np[self.slot_sel == SEL_MEDIAN] *= -1.0
        epochs = s.epochs.cpu().numpy()
        conv = s.converged.cpu().numpy()
        comm_np = type(s.comm)(*(a.cpu().numpy() for a in s.comm))

        for slot in slots:
            sid = int(self.sid[slot])
            rec = self.sessions[sid]
            quarantined = self.slot_state[slot] == SLOT_QUARANTINED
            if not quarantined:
                converged = bool(conv[slot])
                rec["status"] = ST_CONVERGED if converged else ST_BUDGET
                self.stats["evicted_converged" if converged
                           else "evicted_budget"] += 1
                h = clf.LinearSeparator(w_np[slot], float(b_np[slot]))
                sel_name = (SELECTOR_NAMES[int(self.slot_sel[slot])]
                            if cfg.selector == "unified" else cfg.selector)
                self.results[sid] = ProtocolResult(
                    h,
                    comm_np.summary(int(slot), dim=cfg.d),
                    rounds=(int(epochs[slot]) if converged
                            else cfg.max_epochs),
                    converged=converged,
                    extra={"engine": True, "session_pool": True,
                           "selector": sel_name, "sid": sid,
                           "retries": rec["retries"],
                           "backoffs": rec["backoffs"]},
                )
            rec["evicted_turn"] = self.pool_turn
            rec["turns"] = int(self.turns_done[slot])
            self.sid[slot] = -1
            self.slot_sel[slot] = 0
            self.slot_state[slot] = SLOT_EMPTY
        # freed rows stay in the device state until an admission overwrites
        # them; mark them done so no later gather can advance them
        if slots.size:
            self.state = _mark_done(self.state, slots)

    # -- the pool turn ------------------------------------------------------

    def step_pool(self):
        """One pool turn: admit → draw faults → dispatch survivors →
        corrupt → screen invariants → quarantine/evict → checkpoint."""
        cfg = self.cfg
        t = self.pool_turn
        self._admit()

        live = self.slot_state == SLOT_LIVE
        ready = live & (self.backoff_until <= t) & (self.straggle_until <= t)
        cand = np.flatnonzero(ready)

        dispatched = np.empty((0,), np.int64)
        if cand.size:
            draws = self.schedule.draws(self.sid[cand], t)
            aborted = draws["dropout"] | draws["drop_msg"]
            straggle = (~aborted) & (draws["straggle"] > 0)
            go = ~aborted & ~straggle

            for i in np.flatnonzero(aborted):
                slot = cand[i]
                rec = self.sessions[self.sid[slot]]
                which = "dropouts" if draws["dropout"][i] else "drop_msgs"
                rec[which] += 1
                self.stats[which] += 1
                self.retries[slot] += 1
                rec["retries"] += 1
                self.stats["retries_total"] += 1
                if self.retries[slot] > cfg.retry_budget:
                    self._quarantine(slot, "retry_budget")
                else:
                    self.backoff_until[slot] = (
                        t + 1 + cfg.backoff_base
                        * (1 << (int(self.retries[slot]) - 1)))
                    rec["backoffs"] += 1
                    self.stats["backoffs_total"] += 1

            for i in np.flatnonzero(straggle):
                slot = cand[i]
                self.straggle_until[slot] = t + 1 + int(draws["straggle"][i])
                self.sessions[self.sid[slot]]["straggles"] += 1
                self.stats["straggles"] += 1

            dispatched = cand[go]
            if dispatched.size:
                self._dispatch(dispatched)
                self.retries[dispatched] = 0
                self.turns_done[dispatched] += 1
                for slot in dispatched:
                    self.sessions[self.sid[slot]]["turns"] = \
                        int(self.turns_done[slot])

            hit = go & (draws["corrupt"] >= 0)
            if hit.any():
                corrupt_rows = cand[hit]
                corrupt_kinds = draws["corrupt"][hit].astype(np.int32)
                self._corrupt(corrupt_rows, corrupt_kinds)
                self.stats["corruptions"] += int(corrupt_rows.size)
                for slot, kind in zip(corrupt_rows, corrupt_kinds):
                    self.sessions[self.sid[slot]]["corrupt_kind"] = int(kind)

        # -- supervision screen: the turn's one (5, W) transfer -------------
        viewer = {"median": _view_median, "maxmarg": _view_maxmarg,
                  "unified": _view_unified}[cfg.selector]
        view = hotloop.wait_view(hotloop.start_view(viewer(self.state)))
        done, conv, fills, nan, bits = view
        live = self.slot_state == SLOT_LIVE       # minus fresh quarantines

        for slot in np.flatnonzero(live & (nan > 0)):
            self._quarantine(int(slot), "nan_separator")
        for slot in np.flatnonzero(live & (bits > cfg.comm_limit_bits)):
            if self.slot_state[slot] == SLOT_LIVE:
                self._quarantine(int(slot), "comm_blowout")
        disp_mask = np.zeros_like(live)
        disp_mask[dispatched] = True
        # every healthy continuing turn strictly grows some transcript, so
        # a dispatched live row whose max fill dropped, or failed to go (and
        # stay) positive, is corrupt
        bad_fill = disp_mask & live & (done == 0) \
            & ((fills < self.prev_fill) | (fills == 0))
        for slot in np.flatnonzero(bad_fill):
            if self.slot_state[slot] == SLOT_LIVE:
                self._quarantine(int(slot), "fill_regression")

        live = self.slot_state == SLOT_LIVE
        self.prev_fill[live] = np.maximum(self.prev_fill[live], fills[live])

        evict = np.flatnonzero(
            (self.slot_state == SLOT_QUARANTINED)
            | (live & (done > 0))
            | (live & (self.turns_done >= cfg.max_turns)))
        if evict.size:
            self._evict(evict)

        self.pool_turn += 1
        self.stats["pool_turns"] += 1
        if (cfg.checkpoint_every
                and self.pool_turn % cfg.checkpoint_every == 0):
            self.checkpoint(cfg.checkpoint_dir)

    def drained(self) -> bool:
        return not self.pending and not (self.slot_state == SLOT_LIVE).any()

    def run(self, max_pool_turns: Optional[int] = None) -> Dict[int, Any]:
        """Drive pool turns until every submitted session reaches a
        terminal status (or ``max_pool_turns`` elapse).  Returns the
        results ledger (sid -> ProtocolResult for cleanly finished
        sessions; quarantined sids appear only in :meth:`session`)."""
        cfg = self.cfg
        if max_pool_turns is None:
            # worst case: every session serially pays its full turn budget
            # plus a full retry cycle's backoff per turn — generous, finite
            per_turn = 2 + cfg.backoff_base * (2 ** (cfg.retry_budget + 1)) \
                + self.schedule.straggle_max
            n_sessions = len(self.pending) + int(
                (self.slot_state != SLOT_EMPTY).sum())
            waves = max(1, -(-max(n_sessions, 1) // cfg.slots))
            max_pool_turns = max(64, waves * cfg.max_turns * per_turn)
        deadline = self.pool_turn + max_pool_turns
        while not self.drained() and self.pool_turn < deadline:
            self.step_pool()
        if not self.drained():
            raise RuntimeError(
                f"pool failed to drain within {max_pool_turns} pool turns "
                f"({(self.slot_state == SLOT_LIVE).sum()} live, "
                f"{len(self.pending)} pending)")
        return self.results

    # -- checkpoint / restore ----------------------------------------------

    def checkpoint(self, dirname: str) -> str:
        """Snapshot the whole pool — device records, host supervision
        arrays, pending queue, session ledger, config and schedule — as one
        flat-key ``.npz`` and a JSON manifest, in the JAX package's format.
        The fault schedule is stateless, so the snapshot fixes the rest of
        the run."""
        os.makedirs(dirname, exist_ok=True)
        flat = _flatten({"data": self.data, "state": self.state})
        if "state/.hop_keys" in flat:    # JAX's uint32 words: either
            # package's pool restores the snapshot
            flat["state/.hop_keys"] = flat["state/.hop_keys"].astype(
                np.uint32)
        flat.update({
            "host/sid": self.sid, "host/slot_state": self.slot_state,
            "host/retries": self.retries,
            "host/backoff_until": self.backoff_until,
            "host/straggle_until": self.straggle_until,
            "host/prev_fill": self.prev_fill,
            "host/turns_done": self.turns_done,
            "host/slot_sel": self.slot_sel,
        })
        if self.pending:
            flat["pending/sid"] = np.asarray([p.sid for p in self.pending])
            flat["pending/X"] = np.stack([p.X for p in self.pending])
            flat["pending/y"] = np.stack([p.y for p in self.pending])
            flat["pending/budget"] = np.asarray(
                [p.budget for p in self.pending], np.int32)
            flat["pending/selector"] = np.asarray(
                [SELECTOR_CODES[p.selector] for p in self.pending], np.int32)
            flat["pending/seed"] = np.asarray(
                [p.seed for p in self.pending], np.int64)
            flat["pending/res_cap"] = np.asarray(
                [p.res_cap for p in self.pending], np.int32)
        path = os.path.join(dirname, f"pool_{self.pool_turn:08d}.npz")
        np.savez(path, **flat)

        results_json = {}
        for sid, r in self.results.items():
            results_json[str(sid)] = {
                "w": np.asarray(r.classifier.w, np.float64).tolist(),
                "b": float(r.classifier.b),
                "comm": r.comm, "rounds": r.rounds,
                "converged": r.converged, "extra": r.extra,
            }
        manifest = {
            "path": path,
            "pool_turn": self.pool_turn,
            "next_sid": self._next_sid,
            "config": dataclasses.asdict(self.cfg),
            "schedule": self.schedule.to_json(),
            "sessions": {str(k): v for k, v in self.sessions.items()},
            "results": results_json,
            "stats": {k: v for k, v in self.stats.items()
                      if isinstance(v, (int, float, str))},
        }
        with open(os.path.join(dirname, "latest.json"), "w") as f:
            json.dump(manifest, f)
        return path

    @classmethod
    def restore(cls, dirname: str, device="cuda") -> "SessionPool":
        """Rebuild a pool mid-stream on ``device`` from :meth:`checkpoint`
        output (or the JAX pool's).  The device records re-upload
        verbatim, and the supervision arrays and the stateless fault
        schedule replay the same decisions, so unaffected sessions finish
        bit for bit as an uninterrupted pool."""
        from repro_torch.core import classifiers as clf
        from repro_torch.core.protocols.one_way import ProtocolResult

        with open(os.path.join(dirname, "latest.json")) as f:
            man = json.load(f)
        cfg = PoolConfig(**man["config"])
        pool = cls(cfg, F.FaultSchedule.from_json(man["schedule"]),
                   device=device)
        z = np.load(man["path"])

        pool.data = _unflatten(pool.data, z, "data")
        pool.state = _unflatten(pool.state, z, "state")
        pool.sid = z["host/sid"]
        pool.slot_state = z["host/slot_state"]
        pool.retries = z["host/retries"]
        pool.backoff_until = z["host/backoff_until"]
        pool.straggle_until = z["host/straggle_until"]
        pool.prev_fill = z["host/prev_fill"]
        pool.turns_done = z["host/turns_done"]
        pool.slot_sel = z["host/slot_sel"]
        if "pending/sid" in z.files:
            for i, sid in enumerate(z["pending/sid"]):
                pool.pending.append(_Pending(
                    int(sid), z["pending/X"][i], z["pending/y"][i],
                    int(z["pending/budget"][i]),
                    selector=SELECTOR_NAMES[int(z["pending/selector"][i])],
                    seed=int(z["pending/seed"][i]),
                    res_cap=int(z["pending/res_cap"][i])))
        pool.pool_turn = man["pool_turn"]
        pool._next_sid = man["next_sid"]
        pool.sessions = {int(k): v for k, v in man["sessions"].items()}
        for sid, r in man["results"].items():
            pool.results[int(sid)] = ProtocolResult(
                clf.LinearSeparator(np.asarray(r["w"]), r["b"]),
                r["comm"], rounds=r["rounds"], converged=r["converged"],
                extra=r["extra"])
        for k, v in man["stats"].items():
            pool.stats[k] = v
        return pool
