"""Seeded deterministic fault model for the streaming session pool.

The paper's protocols assume every node answers every round; a persistent
service does not get that luxury (cf. the resilient-boosting setting of
arXiv:2206.04713).  This module is the *failure half* of the session-pool
contract (DESIGN.md §session pool & failure model): a stateless, seeded
schedule that decides — per (session, pool turn) — whether that session's
next protocol turn

* **drops out** (a node never answers: the turn is aborted host-side and
  retried with exponential backoff),
* **loses a message** (a transcript message is dropped in flight — same
  host-visible outcome as a dropout, counted separately),
* **straggles** (the turn completes but only after a deterministic number
  of extra pool turns — the session is simply absent from dispatches in
  the meantime; no retry is charged), or
* **is corrupted** (the turn runs and then one of three state corruptions
  lands, each paired with exactly one supervisor invariant check:
  ``CORRUPT_NAN`` → NaN separator, ``CORRUPT_FILL`` → non-monotone
  transcript fill, ``CORRUPT_COMM`` → comm-budget blowout).

Determinism is the load-bearing property: draws are a pure splitmix64-style
hash of ``(seed, session_id, pool_turn)`` with one salt per channel, so

* there is **no RNG state to checkpoint** — a restored pool replays the
  identical schedule for the identical (session, turn) pairs;
* two runs with the same seed produce identical eviction sets, retry
  counts and surviving-session decisions (tests/test_faults.py,
  tests/test_session_pool.py);
* keying on the *pool* turn (not the session's protocol turn) means a
  retried turn faces a **fresh draw** — a transient fault cannot pin a
  session in a deterministic retry livelock; persistent bad luck exhausts
  the retry budget and quarantines instead.

What the injector may and may not touch (the metering invariant): dropouts,
lost messages and stragglers only *delay* dispatches — they never mutate
protocol state, so a session that survives them reaches the exact same
final separator as a fault-free run (the pool's bit-exactness criterion).
Corruption mutates the victim's own state only, after the turn's metered
appends — delivered messages are always metered exactly; a corrupted
session is detected and quarantined, never silently served.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np

# corruption kinds — each maps 1:1 onto a supervisor invariant check
CORRUPT_NAN = 0    # separator turns NaN            → NaN invariant
CORRUPT_FILL = 1   # transcript fill decremented    → monotone-fill invariant
CORRUPT_COMM = 2   # comm bits counter spiked       → comm-budget invariant
N_CORRUPT_KINDS = 3

# the comm-counter spike CORRUPT_COMM adds — far beyond any legitimate
# per-turn bit cost (k-1 bits/turn), so the blowout check cannot false-fire
COMM_SPIKE_BITS = 1 << 20

_MASK = np.uint64(0xFFFFFFFFFFFFFFFF)
_GAMMA = np.uint64(0x9E3779B97F4A7C15)
_M1 = np.uint64(0xBF58476D1CE4E5B9)
_M2 = np.uint64(0x94D049BB133111EB)

# per-channel salts (arbitrary distinct odd constants)
_SALT = {
    "dropout": np.uint64(0xD1B54A32D192ED03),
    "drop_msg": np.uint64(0x8CB92BA72F3D8DD7),
    "straggle": np.uint64(0xABC98388FB8FAC03),
    "straggle_len": np.uint64(0x49BEB2B3D3BBF853),
    "corrupt": np.uint64(0x7E46CA1B0BC29F43),
    "corrupt_kind": np.uint64(0x93D765DD3F5B1F2D),
}


def _mix(x: np.ndarray) -> np.ndarray:
    """splitmix64 finalizer: uint64 array -> uint64 array, bijective."""
    with np.errstate(over="ignore"):
        z = (x + _GAMMA) & _MASK
        z = ((z ^ (z >> np.uint64(30))) * _M1) & _MASK
        z = ((z ^ (z >> np.uint64(27))) * _M2) & _MASK
        return z ^ (z >> np.uint64(31))


def _hash_u01(seed: int, sids: np.ndarray, pool_turn: int,
              salt: np.uint64) -> np.ndarray:
    """Uniform [0, 1) draw per session id — pure in (seed, sid, turn, salt)."""
    sids = np.asarray(sids, np.uint64)
    with np.errstate(over="ignore"):
        h = _mix(np.uint64(seed) ^ salt)
        h = _mix(h ^ _mix(sids))
        h = _mix(h ^ _mix(np.uint64(pool_turn) + salt))
    return h.astype(np.float64) / float(2 ** 64)


@dataclasses.dataclass(frozen=True)
class FaultSchedule:
    """A seeded fault schedule: probabilities per channel plus the seed.

    ``draws(session_ids, pool_turn)`` is the whole API — a pure function,
    so the schedule itself carries no state (nothing to checkpoint).  All
    probabilities default to 0, making ``FaultSchedule(seed)`` an explicit
    fault-free schedule (useful as the oracle arm of differential tests).
    """

    seed: int = 0
    p_dropout: float = 0.0     # node never answers: abort + retry/backoff
    p_drop_msg: float = 0.0    # transcript message lost: abort + retry
    p_straggle: float = 0.0    # turn delayed, no retry charged
    p_corrupt: float = 0.0     # state corrupted post-turn: detect + evict
    straggle_max: int = 3      # straggle duration drawn from [1, straggle_max]

    def __post_init__(self):
        for f in ("p_dropout", "p_drop_msg", "p_straggle", "p_corrupt"):
            p = getattr(self, f)
            if not 0.0 <= p <= 1.0:
                raise ValueError(f"{f}={p} outside [0, 1]")
        if self.straggle_max < 1:
            raise ValueError("straggle_max must be >= 1")

    @property
    def any_faults(self) -> bool:
        return (self.p_dropout > 0 or self.p_drop_msg > 0
                or self.p_straggle > 0 or self.p_corrupt > 0)

    def draws(self, session_ids: np.ndarray,
              pool_turn: int) -> Dict[str, np.ndarray]:
        """Fault draws for each session about to be dispatched on this pool
        turn.  Returns numpy arrays aligned with ``session_ids``:

        * ``dropout``  (bool) — node dropout aborts the turn;
        * ``drop_msg`` (bool) — lost message aborts the turn;
        * ``straggle`` (i32)  — extra pool turns the session stays absent
          (0 = on time); drawn uniformly from [1, straggle_max] when hit;
        * ``corrupt``  (i32)  — corruption kind (``CORRUPT_*``) applied
          after the turn, -1 for none.

        Channels are independent; the pool resolves precedence (abort
        beats straggle beats corrupt — an aborted turn never ran, so there
        is nothing to corrupt).
        """
        sids = np.asarray(session_ids, np.int64)
        u_drop = _hash_u01(self.seed, sids, pool_turn, _SALT["dropout"])
        u_msg = _hash_u01(self.seed, sids, pool_turn, _SALT["drop_msg"])
        u_str = _hash_u01(self.seed, sids, pool_turn, _SALT["straggle"])
        u_len = _hash_u01(self.seed, sids, pool_turn, _SALT["straggle_len"])
        u_cor = _hash_u01(self.seed, sids, pool_turn, _SALT["corrupt"])
        u_knd = _hash_u01(self.seed, sids, pool_turn, _SALT["corrupt_kind"])

        straggle = np.where(
            u_str < self.p_straggle,
            1 + (u_len * self.straggle_max).astype(np.int32), 0)
        corrupt = np.where(
            u_cor < self.p_corrupt,
            (u_knd * N_CORRUPT_KINDS).astype(np.int32), -1)
        return {
            "dropout": u_drop < self.p_dropout,
            "drop_msg": u_msg < self.p_drop_msg,
            "straggle": straggle.astype(np.int32),
            "corrupt": corrupt.astype(np.int32),
        }

    def to_json(self) -> Dict[str, float]:
        """Schedule as a plain dict (checkpoint manifests, bench reports)."""
        return dataclasses.asdict(self)

    @staticmethod
    def from_json(d: Dict[str, float]) -> "FaultSchedule":
        return FaultSchedule(**d)


FAULT_FREE = FaultSchedule(seed=0)
