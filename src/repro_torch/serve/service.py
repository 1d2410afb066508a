"""Protocol serving: the streaming front end over the fault-tolerant
session pool (counterpart of ``repro.serve.service``).

The primary entry point of :mod:`repro_torch.serve`: callers open
sessions, stream labeled points per node, close the session to enqueue it,
and pump the pool — while :mod:`repro_torch.engine.session_pool` handles
admission into freed slots at its one launch shape, seeded fault
injection, retry/backoff supervision and checkpoint/restore underneath,
on the pool's device.

Ingest is reservoir-based (``core.sampling.Reservoir.add_batch``): each
node of an open session downsamples its stream into a reservoir of
capacity ≤ the pool's pinned ``n_pad``, and :meth:`ProtocolService.close`
takes the reservoir snapshot as that node's shard (the pool pads it to the
pinned shape with inert label-0 rows) — so unbounded streams admit at
bounded, shape-stable cost, and the reservoir's Vitter inclusion
probabilities are the paper's one-way sampling semantics.
Callers with ready-made shards can skip the stream and :meth:`submit`
directly.

Each node's reservoir is seeded with ``np.random.default_rng((ingest_seed,
handle, node))``, as in the JAX package, so both packages stream the same
rows.  The token-decode engine, ``repro_torch.serve.engine.
TokenServingEngine``, is unrelated to protocol serving.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.sampling import Reservoir
from repro_torch.engine.faults import FaultSchedule
from repro_torch.engine.session_pool import PoolConfig, SessionPool


@dataclasses.dataclass
class _OpenSession:
    reservoirs: List[Reservoir]
    eps: Optional[float]
    selector: Optional[str] = None
    seed: int = 0


class ProtocolService:
    """Streaming protocol service: reservoir ingest → session pool.

    ::

        svc = ProtocolService(PoolConfig(slots=32, k=2, n_pad=64),
                              schedule=FaultSchedule(seed=7, p_dropout=0.05),
                              device="cuda")
        h = svc.open()
        svc.feed(h, node=0, X=batch0, y=labels0)   # any number of batches
        svc.feed(h, node=1, X=batch1, y=labels1)
        sid = svc.close(h)                          # enqueue for admission
        svc.run()                                   # drain the pool
        svc.result(sid)                             # ProtocolResult
        svc.status(sid), svc.stats                  # supervision surface

    The service adds no decision logic of its own: every admission,
    dispatch, fault, retry and eviction decision is the pool's, so the
    pool's determinism and bit-exactness contracts carry over verbatim
    (same workload + config + schedule ⇒ same decisions, including across
    :meth:`checkpoint` / :meth:`restore`).  On a
    ``PoolConfig(selector="unified")`` pool, :meth:`open` and :meth:`submit`
    take a per-session ``selector`` (and Vitter ``seed``), so one service
    instance absorbs heterogeneous MEDIAN / MAXMARG / SAMPLING traffic.

    Launch-shape contract (inherited from the pool): every launch shape is
    fixed by ``PoolConfig`` and the device alone.  Nothing streamed
    through this API (batch sizes fed per node, session count, ε, selector
    mix, seeds, admission order) changes it; per-node stream length is
    decoupled from the pinned shapes by the reservoir, which downsamples
    any stream to ≤ ``n_pad`` rows.
    """

    def __init__(self, config: PoolConfig,
                 schedule: Optional[FaultSchedule] = None,
                 ingest_seed: int = 0, device="cuda"):
        self.pool = SessionPool(config, schedule, device=device)
        self.cfg = config
        self._ingest_seed = ingest_seed
        self._open: Dict[int, _OpenSession] = {}
        self._next_handle = 0

    # -- streaming ingest ---------------------------------------------------

    def open(self, eps: Optional[float] = None,
             reservoir_capacity: Optional[int] = None,
             selector: Optional[str] = None, seed: int = 0) -> int:
        """Open a streaming session: one reservoir per node, capacity
        ``reservoir_capacity`` (default: the pool's pinned ``n_pad``).
        ``selector``/``seed`` tag the session's protocol family on unified
        pools (validated at :meth:`close`, when the pool sees them).
        Returns an ingest handle (not yet a pool session id)."""
        cap = self.cfg.n_pad if reservoir_capacity is None \
            else reservoir_capacity
        if cap > self.cfg.n_pad:
            raise ValueError(
                f"reservoir capacity {cap} exceeds pinned n_pad="
                f"{self.cfg.n_pad}")
        h = self._next_handle
        self._next_handle += 1
        self._open[h] = _OpenSession(
            reservoirs=[
                Reservoir(cap, self.cfg.d,
                          rng=np.random.default_rng(
                              (self._ingest_seed, h, node)))
                for node in range(self.cfg.k)],
            eps=eps, selector=selector, seed=seed)
        return h

    def feed(self, handle: int, node: int, X: np.ndarray,
             y: np.ndarray) -> None:
        """Stream a labeled batch into one node's reservoir
        (``Reservoir.add_batch`` — vectorized Vitter)."""
        sess = self._open[handle]
        if not 0 <= node < self.cfg.k:
            raise ValueError(f"node {node} outside 0..{self.cfg.k - 1}")
        sess.reservoirs[node].add_batch(X, y)

    def close(self, handle: int) -> int:
        """Finalize a streaming session: take each node's reservoir snapshot
        (the filled rows only — the pool pads to its pinned ``n_pad`` with
        inert label-0 rows, keeping the error budget on real points) and
        enqueue the instance for admission.  Returns the pool session id."""
        sess = self._open.pop(handle)
        shards = []
        for r in sess.reservoirs:
            if r.filled == 0:
                raise ValueError("cannot close a session with an empty node")
            shards.append(r.sample())
        return self.pool.submit(shards, eps=sess.eps,
                                selector=sess.selector, seed=sess.seed)

    def submit(self, shards: Sequence[Tuple[np.ndarray, np.ndarray]],
               eps: Optional[float] = None,
               selector: Optional[str] = None, seed: int = 0) -> int:
        """Enqueue ready-made shards directly (no streaming)."""
        return self.pool.submit(shards, eps=eps, selector=selector,
                                seed=seed)

    # -- pool pump ----------------------------------------------------------

    def step(self) -> None:
        """Advance the pool by one turn (admission → dispatch → screen)."""
        self.pool.step_pool()

    def run(self, max_pool_turns: Optional[int] = None) -> Dict[int, Any]:
        """Drain every enqueued session to a terminal status."""
        return self.pool.run(max_pool_turns)

    # -- results & supervision surface --------------------------------------

    def result(self, sid: int):
        return self.pool.results.get(sid)

    def status(self, sid: int) -> str:
        return self.pool.sessions[sid]["status"]

    def session(self, sid: int) -> Dict[str, Any]:
        return self.pool.sessions[sid]

    @property
    def stats(self) -> Dict[str, Any]:
        return self.pool.stats

    # -- persistence --------------------------------------------------------

    def checkpoint(self, dirname: str) -> str:
        """Snapshot the pool (open ingest handles are host-side reservoirs
        and are NOT captured — close them first; enqueued and live sessions
        round-trip bit-exact)."""
        if self._open:
            raise RuntimeError(
                f"{len(self._open)} ingest session(s) still open; close "
                "them before checkpointing (reservoir RNG state is not "
                "snapshotted)")
        return self.pool.checkpoint(dirname)

    @classmethod
    def restore(cls, dirname: str, device="cuda") -> "ProtocolService":
        """A service over the pool restored from ``dirname``.  As in the
        JAX package, the manifest holds no ingest state: the ingest seed
        and the handle counter start at 0 again, so a stream of more than
        ``n_pad`` rows a node opened after the restore is downsampled
        otherwise than it would have been without it."""
        svc = cls.__new__(cls)
        svc.pool = SessionPool.restore(dirname, device=device)
        svc.cfg = svc.pool.cfg
        svc._ingest_seed = 0
        svc._open = {}
        svc._next_handle = 0
        return svc
