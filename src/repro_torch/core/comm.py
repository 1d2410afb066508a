"""Communication accounting — the paper's scarce resource, metered.

The paper (§1) treats inter-node communication as the resource to optimize and
reports protocol cost in *points communicated* (Tables 2-4).  Every protocol in
``repro.core.protocols`` moves data exclusively through :class:`Channel`
objects owned by a :class:`CommLog`, so costs are measured, never estimated.

Units
-----
``points``   number of labeled points shipped (the paper's unit).
``scalars``  number of raw floats (directions, offsets, thresholds).
``bits``     control bits (the ±1 votes of the two-way protocol).
``bytes``    derived from the exact wire bit count
             points * (d+1) * 32 + scalars * 32 + bits, ceiled to bytes
             **once, over the aggregate** (float32 wire format, control bits
             packed across the whole trace).  Used to compare against
             gradient-synchronization baselines in the trainer integration.

The aggregate convention is canonical: per-message byte attribution must use
:meth:`CommLog.message_nbytes` (packed-stream deltas), which sums exactly to
``summary()["bytes"]``.  Ceiling each message separately overstates the total
whenever a protocol sends multiple sub-byte bit votes.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import numpy as np


def wire_bits(points: int, scalars: int, bits: int, dim: int) -> int:
    """Exact wire size in bits: a labeled point is d+1 float32s, a scalar one
    float32, control bits count as themselves.  The exact-bit form is the
    primitive every byte figure derives from — it is additive across
    messages, so packed-stream accounting stays consistent at any
    granularity."""
    return (points * (dim + 1) + scalars) * 32 + bits


def wire_bytes(points: int, scalars: int, bits: int, dim: int) -> int:
    """Canonical float32 wire size: ``ceil(wire_bits / 8)`` — the bit total
    is ceiled to bytes once, over whatever aggregate is being priced.  Single
    source of truth for every accounting path (Message, CommStats, and the
    engine's BatchCommLog).  Float payloads are byte-aligned, so this equals
    the historical ``points*(d+1)*4 + scalars*4 + ceil(bits/8)`` form."""
    return -(-wire_bits(points, scalars, bits, dim) // 8)


@dataclasses.dataclass
class Message:
    """One transmission between two nodes."""

    src: str
    dst: str
    points: int = 0
    scalars: int = 0
    bits: int = 0
    tag: str = ""
    payload: Any = None

    def wire_bits(self, dim: int) -> int:
        return wire_bits(self.points, self.scalars, self.bits, dim)

    def nbytes(self, dim: int) -> int:
        """Byte cost of this message priced as a standalone trace (its bit
        payload ceiled alone).  Inside a trace this is an upper bound: the
        canonical per-message attribution packs bits across the stream —
        use :meth:`CommLog.message_nbytes`, which sums exactly to
        ``summary()["bytes"]``."""
        return wire_bytes(self.points, self.scalars, self.bits, dim)


@dataclasses.dataclass
class CommStats:
    points: int = 0
    scalars: int = 0
    bits: int = 0
    messages: int = 0
    rounds: int = 0

    def nbytes(self, dim: int) -> int:
        return wire_bytes(self.points, self.scalars, self.bits, dim)


class CommLog:
    """Ledger of all communication in one protocol execution."""

    def __init__(self, dim: int):
        self.dim = dim
        self.messages: List[Message] = []
        self.rounds = 0

    def send(
        self,
        src: str,
        dst: str,
        *,
        points: Optional[np.ndarray] = None,
        labels: Optional[np.ndarray] = None,
        scalars: int = 0,
        bits: int = 0,
        tag: str = "",
        payload: Any = None,
    ) -> Any:
        """Record a message; returns the payload (simulating the wire)."""
        n_points = 0 if points is None else int(np.atleast_2d(points).shape[0])
        msg = Message(
            src=src,
            dst=dst,
            points=n_points,
            scalars=scalars,
            bits=bits,
            tag=tag,
            payload=payload if payload is not None else (points, labels),
        )
        self.messages.append(msg)
        return msg.payload

    def new_round(self) -> None:
        self.rounds += 1

    def message_nbytes(self) -> List[int]:
        """Per-message byte attribution under the canonical aggregate
        convention: message i is charged the growth of the packed stream,
        ``ceil(cum_bits_i / 8) - ceil(cum_bits_{i-1} / 8)``, so the list sums
        to ``summary()["bytes"]`` exactly — unlike ceiling each message alone,
        which double-charges partial bytes of consecutive bit votes."""
        out, cum, prev = [], 0, 0
        for m in self.messages:
            cum += m.wire_bits(self.dim)
            ceiled = -(-cum // 8)
            out.append(ceiled - prev)
            prev = ceiled
        return out

    @property
    def stats(self) -> CommStats:
        s = CommStats(rounds=self.rounds, messages=len(self.messages))
        for m in self.messages:
            s.points += m.points
            s.scalars += m.scalars
            s.bits += m.bits
        return s

    def cost_points(self) -> int:
        """The paper's 'Cost' column: total labeled points shipped."""
        return self.stats.points

    def summary(self) -> Dict[str, Any]:
        s = self.stats
        return {
            "points": s.points,
            "scalars": s.scalars,
            "bits": s.bits,
            "messages": s.messages,
            "rounds": s.rounds,
            "bytes": s.nbytes(self.dim),
        }


class Node:
    """One party holding a disjoint shard ``(X, y)`` of the global dataset.

    ``X`` is (n, d) float array, ``y`` is (n,) in {-1, +1}.  Nodes interact
    only through :meth:`send`, which meters the channel.
    """

    def __init__(self, name: str, X: np.ndarray, y: np.ndarray, log: CommLog):
        X = np.asarray(X, dtype=np.float64)
        y = np.asarray(y, dtype=np.int32)
        assert X.ndim == 2 and y.shape == (X.shape[0],), (X.shape, y.shape)
        assert set(np.unique(y)).issubset({-1, 1}), "labels must be +-1"
        self.name = name
        self.X = X
        self.y = y
        self.log = log
        # points received from other nodes (accumulated protocol transcript W)
        self.recv_X: np.ndarray = np.zeros((0, X.shape[1]))
        self.recv_y: np.ndarray = np.zeros((0,), dtype=np.int32)

    # -- data views ---------------------------------------------------------
    @property
    def d(self) -> int:
        return self.X.shape[1]

    @property
    def n(self) -> int:
        return self.X.shape[0]

    def pos(self) -> np.ndarray:
        return self.X[self.y == 1]

    def neg(self) -> np.ndarray:
        return self.X[self.y == -1]

    def all_known(self) -> Tuple[np.ndarray, np.ndarray]:
        """Own points plus everything received so far."""
        X = np.concatenate([self.X, self.recv_X], axis=0)
        y = np.concatenate([self.y, self.recv_y], axis=0)
        return X, y

    # -- communication ------------------------------------------------------
    def send_points(self, dst: "Node", X: np.ndarray, y: np.ndarray, tag: str = "") -> None:
        X = np.atleast_2d(np.asarray(X, dtype=np.float64))
        y = np.atleast_1d(np.asarray(y, dtype=np.int32))
        if X.shape[0] == 0:
            # empty messages still cost one message-slot but no points
            self.log.send(self.name, dst.name, points=None, tag=tag)
            return
        self.log.send(self.name, dst.name, points=X, labels=y, tag=tag)
        dst.recv_X = np.concatenate([dst.recv_X, X], axis=0)
        dst.recv_y = np.concatenate([dst.recv_y, y], axis=0)

    def send_scalars(self, dst: "Node", values: np.ndarray, tag: str = "") -> np.ndarray:
        values = np.atleast_1d(np.asarray(values, dtype=np.float64))
        self.log.send(self.name, dst.name, scalars=values.size, tag=tag, payload=values)
        return values

    def send_bit(self, dst: "Node", bit: int, tag: str = "") -> int:
        self.log.send(self.name, dst.name, bits=1, tag=tag, payload=bit)
        return bit


def make_nodes(
    shards: List[Tuple[np.ndarray, np.ndarray]], names: Optional[List[str]] = None
) -> Tuple[List[Node], CommLog]:
    """Build k nodes sharing one CommLog from a list of (X, y) shards."""
    assert shards, "need at least one shard"
    d = shards[0][0].shape[1]
    log = CommLog(dim=d)
    if names is None:
        names = [chr(ord("A") + i) if i < 26 else f"P{i}" for i in range(len(shards))]
    nodes = [Node(nm, X, y, log) for nm, (X, y) in zip(names, shards)]
    return nodes, log
