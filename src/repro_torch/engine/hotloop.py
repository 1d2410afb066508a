"""Selector-generic host-driven hot loop (counterpart of
``repro.engine.hotloop``; DESIGN.md §shared hot loop).

The host drives the selector's ``step`` one turn at a time so shapes can
change between turns:

* **one packed transfer per turn** — done flags, warm flags and live
  transcript fills cross to the host as one (3, B) int32 view;
* **warm refits** (``warm=True``, MAXMARG) — from turn 1 on, a turn whose
  view shows a live instance that may latch its carried separator
  dispatches with ``use_warm=True``; the others skip the polish;
* **width compaction** — per-turn transcript reads run at
  ``round_up(max live fill + slack, 8)`` rows instead of the capacity;
* **batch compaction** — finished instances drop out of the dispatch: the
  live set rounds up to a multiple of 4 (at most B) and pads with the
  out-of-range index B.  JAX gathers such an index as a zero-filled row and drops it on
  scatter; torch would raise, so :func:`take_instances` gathers with a
  clamped index and zero-fills the pad rows, and :func:`put_instances`
  scatters back only the live prefix — the same semantics;
* **sharded dispatch** (DESIGN.md §sharded hot loop) — the state is a
  tuple of S per-shard records (``state.device_put_sharded``; S = 1 on
  one device) and the per-turn sub-batch index is built *per shard*
  (:func:`balanced_index`): the live set splits into S local slices padded
  to a common multiple of ``BATCH_MULT``; each shard's turn runs on its
  own device;
* **double buffering** (``overlap=True``) — turn t+1 is dispatched from the
  one-turn-stale view before the host waits on turn t's view.

``KEY_LOG`` records every compacted dispatch's launch shape
``(n_pad, width, use_warm, first_turn)`` exactly as the JAX loop records
its compile keys; the session pool appends its one pinned shape.
"""

from __future__ import annotations

from typing import Callable, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.engine.state import _round_up, shard_specs, tree_map  # noqa: F401 (re-export)

BATCH_MULT = 4   # live batch rounds up to this
WIDTH_MULT = 8   # live transcript width rounds up to this

# every compacted dispatch appends its launch shape here:
# (n_pad, width, use_warm, first_turn) with n_pad = B for full-batch turns
KEY_LOG: List[Tuple[int, int, bool, bool]] = []


def quantize_width(w: int, cap: int, policy: str = "linear") -> int:
    """Round a live transcript width up to a dispatchable bucket.

    ``"linear"`` is ``min(cap, round_up(w, WIDTH_MULT))``.  ``"geometric"``
    rounds up to the next bucket of 8, 16, 24, 40, 64, 96, 144, ... (each
    about 1.5 times the last, re-rounded to ``WIDTH_MULT``), the unified
    sweep's default: mixed traffic spreads live fills across families that
    grow at very different rates, and geometric buckets keep the distinct
    launch shapes to O(log cap) at most 50% padding.  Both keep ``w = 0``
    exactly (MAXMARG's empty-transcript first turn reads no transcript).
    The buckets are the JAX loop's, policy for policy.
    """
    w = min(cap, _round_up(w, WIDTH_MULT))
    if policy == "linear" or w <= WIDTH_MULT:
        return w
    if policy != "geometric":
        raise ValueError(f"unknown width policy {policy!r}")
    b = WIDTH_MULT
    while b < w:
        b = _round_up((b * 3) // 2, WIDTH_MULT)
    return min(cap, b)


def gather_rows(arr: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """arr (B, N, ...), idx (B,) -> (B, ...): per-instance row gather (the
    coordinator index ``ci = turn % k`` is per-instance)."""
    rows = torch.arange(arr.shape[0], device=arr.device)
    return arr[rows, idx.long()]


def take_instances(tree, idx: torch.Tensor, n_act: int):
    """Gather instance rows ``idx`` from every (B, ...) leaf; rows at and past
    ``n_act`` (the out-of-range pad indices) come back zero-filled — an
    all-label-0 instance is the engine's inert element."""
    def take(a):
        if a.ndim == 0:
            return a
        sub = a.index_select(0, idx.clamp(max=a.shape[0] - 1))
        sub[n_act:] = 0
        return sub
    return tree_map(take, tree)


def put_instances(full, sub, idx: torch.Tensor, n_act: int):
    """Scatter the live prefix ``sub[:n_act]`` back into ``full`` at
    ``idx[:n_act]``, in place (scalar leaves take the sub value); the pad
    rows never land."""
    live = idx[:n_act]

    def put(f, s):
        if f.ndim == 0:
            return s
        return f.index_copy_(0, live, s[:n_act])
    return tree_map(put, full, sub)


def gathered_turn(step_fn, pad_fix, data, state, idx, n_act: int):
    """One compacted turn as gather → pad-fix → step → scatter.  ``idx`` is
    (n_pad,) with the live rows in front and the out-of-range index B in the
    tail; ``pad_fix(sub_state, pad_row)`` marks the tail rows inert."""
    sub_data = take_instances(data, idx, n_act)
    sub = take_instances(state, idx, n_act)
    pad_row = torch.arange(idx.shape[0], device=idx.device) >= n_act
    sub = pad_fix(sub, pad_row)
    sub = step_fn(sub_data, sub)
    return put_instances(state, sub, idx, n_act)


class PendingView(NamedTuple):
    """A (3, B) host view on its way to the host."""

    host: torch.Tensor                  # (3, B) i32, pinned on a CUDA run
    ready: Optional[torch.cuda.Event]   # None when already on the host


def start_view(packed: torch.Tensor) -> PendingView:
    """Start the one device→host transfer of a turn without waiting."""
    if packed.device.type != "cuda":
        return PendingView(packed, None)
    host = torch.empty(packed.shape, dtype=packed.dtype, pin_memory=True)
    host.copy_(packed, non_blocking=True)
    ready = torch.cuda.Event()
    ready.record(torch.cuda.current_stream(packed.device))
    return PendingView(host, ready)


def wait_view(pending) -> np.ndarray:
    """Wait for a started view and return it as a (3, B) numpy array; a
    list of per-shard views comes back as one view, the shards' columns in
    order."""
    if isinstance(pending, list):
        return np.concatenate([wait_view(p) for p in pending], axis=1)
    if pending.ready is not None:
        pending.ready.synchronize()
    return pending.host.numpy()


def shard_skew(counts: np.ndarray) -> float:
    """Imbalance of a per-shard live-count vector as the max/mean ratio.

    1.0 is perfectly balanced; S (the shard count) means one shard owns the
    whole live set.  The common padded length L in :func:`balanced_index`
    is set by the *max* count, so every shard pays the skewed shard's
    shapes: the ratio is the padding-waste factor.  An all-dead vector
    reports 0.0 (no dispatch, no waste)."""
    counts = np.asarray(counts, dtype=np.float64)
    mean = counts.mean() if counts.size else 0.0
    if mean <= 0:
        return 0.0
    return float(counts.max() / mean)


def balanced_index(act: np.ndarray, B: int, shards: int):
    """Shard-balanced compacted index for a sharded sub-batch dispatch.

    Splits the sorted global active set into per-shard *local* index slices
    (shard s owns global rows ``[s·B/S, (s+1)·B/S)``), pads every slice to
    the common ``L = round_up(max per-shard live count, BATCH_MULT)`` with
    the out-of-range index B (gather-fill / scatter-drop, the single-device
    tail's convention), and returns ``(idx, n_act)``: ``idx`` is (S·L,) i32
    — shard s's slice at ``idx[s·L:(s+1)·L]`` — and ``n_act`` the (S,)
    per-shard live counts.  Every shard runs the same compacted shapes.
    """
    B_loc = B // shards
    shard_of = act // B_loc
    counts = np.bincount(shard_of, minlength=shards).astype(np.int32)
    L = max(BATCH_MULT, _round_up(int(counts.max()), BATCH_MULT))
    idx = np.full((shards, L), B, np.int32)
    local = (act - shard_of * B_loc).astype(np.int32)
    offs = np.concatenate([[0], np.cumsum(counts)])
    for s in range(shards):          # act is sorted -> slices stay ordered
        idx[s, :counts[s]] = local[offs[s]:offs[s + 1]]
    return idx.reshape(-1), counts


def write_into(dst, src):
    """Copy every leaf of record ``src`` into ``dst``'s tensor in place
    (leaves that already are the same tensor are left alone); returns
    ``dst``.  A donating ``step`` ends with this: the turn lands in its
    input state's buffers."""
    def put(d, s):
        if d is not s:
            d.copy_(s)
        return d
    return tree_map(put, dst, src)


def run_hot(
    data: Sequence,
    state: Sequence,
    *,
    k: int,
    max_turns: int,
    cap: int,
    host_view: Callable,      # (state, ci) -> (3, B) i32 [done, warm, fill]
    dispatch_full: Callable,  # (data, state, *, t, width, use_warm) -> state
    dispatch_sub: Callable,   # (data, state, idx, n_act, *, t, width,
                              #  use_warm) -> state
    warm: bool = False,
    compact: bool = True,
    width_slack: int = 0,
    width_growth: int = 0,
    width_policy: str = "linear",
    overlap: bool = False,
    stats: Optional[dict] = None,
    donate: bool = False,
) -> tuple:
    """The generic host-driven sweep loop over a selector's ``step``.

    ``data`` and ``state`` are tuples of S per-shard records (S = 1 on one
    device; ``state.device_put_sharded`` splits a record over a mesh), and
    the loop returns the S final records.  The callbacks work on one
    shard's records.  ``host_view`` returns the packed per-turn host
    knowledge on the shard's device: row 0 done flags, row 1 the upcoming
    coordinator's warm-latch flags (zero for MEDIAN), row 2 the transcript
    fills the width compaction keys on; it crosses to the host once per
    shard and turn, and the S views are read as one, the shards' columns in
    order.  With ``warm`` a dispatch gets ``use_warm=True`` from turn 1 on
    whenever a live instance's warm flag is set: polish only where it can
    latch.  ``width_slack`` widens the compacted read past the turn-start
    fill (MEDIAN's stage-5 scan reads transcripts after the S append).
    ``width_policy`` picks the :func:`quantize_width` rule.
    ``dispatch_full`` runs a shard's whole slice at a compacted ``width``
    (``None`` on the non-compacted path); ``dispatch_sub`` gathers the
    shard's local ``idx`` rows (the first ``n_act`` live), steps them and
    scatters them back in place.  Sub-batch turns index through
    :func:`balanced_index`, each shard's slice capped at its B/S rows (on
    one device: at B, the JAX loop's tail); a shard with no live rows is
    left as it is.

    Donation contract: the loop owns its state chain.  It copies the
    caller's state once on entry, so sub-batch turns may scatter into it
    in place; with ``donate=True`` it takes the caller's tensors as they
    are (the caller gives them up), and a donating selector writes every
    turn into them (:func:`write_into`).  Each state is passed to exactly
    one dispatch, and a turn's host view is enqueued before the dispatch
    that writes over its state.

    ``stats`` (a dict) collects host-side observability on sharded sweeps
    (S > 1): each :func:`balanced_index` call folds its skew
    (:func:`shard_skew`) into ``stats["shard_skew_max"]`` /
    ``stats["shard_skew_last"]`` and counts in
    ``stats["shard_dispatches"]``.  It is never read for decisions.

    ``overlap=True`` dispatches turn t+1 from the one-turn-stale view
    before waiting on turn t's view.  Stale parameters are sound: ``done``
    is monotone, so the stale active set is a superset whose extra rows are
    masked no-ops, and the stale fill plus ``width_growth`` covers the true
    fill.  MEDIAN stays bit-exact; a warm selector may make other, equally
    valid, polish-skip choices (the solver re-checks its warm gate).  At
    most one wasted all-done masked dispatch runs at termination.
    """
    S = len(state)
    if S > 1 and not compact:
        raise ValueError("sharded sweeps require the compacted hot path")
    B = sum(int(p.done.shape[0]) for p in state)
    devices = [p.done.device for p in state]
    # turn is per-instance; a sweep advances every row in lock-step, so the
    # host-side loop counter resumes from the common (max) value
    t = max(int(p.turn.max()) for p in state)
    if not donate:
        state = tuple(tree_map(torch.clone, p) for p in state)

    def view(s, ci):
        return [start_view(host_view(p, ci)) for p in s]

    def full(s, **kw):
        return tuple(dispatch_full(d, p, **kw) for d, p in zip(data, s))

    if not compact:
        while t < max_turns:
            done, warm_ok, _fills = wait_view(view(state, t % k))
            if bool(done.all()):
                break
            act = np.flatnonzero(done == 0)
            use_warm = warm and t > 0 and bool(warm_ok[act].any())
            state = full(state, t=t, width=None, use_warm=use_warm)
            t += 1
        return state

    def params(done, warm_ok, fills, t, growth):
        act = np.flatnonzero(done == 0)
        # polish only where it can latch: turn 0 has no carry, and a turn
        # where no live instance may latch falls through to the cold anneal
        use_warm = warm and t > 0 and bool(warm_ok[act].any())
        width = quantize_width(int(fills[act].max(initial=0))
                               + width_slack + growth, cap,
                               width_policy)
        return act, width, use_warm

    def dispatch(state, act, width, use_warm, t):
        if len(act) == B:
            KEY_LOG.append((B, width, use_warm, t == 0))
            return full(state, t=t, width=width, use_warm=use_warm)
        idx, n_vec = balanced_index(act, B, S)
        if S > 1 and stats is not None:
            skew = shard_skew(n_vec)
            stats["shard_skew_last"] = skew
            stats["shard_skew_max"] = max(stats.get("shard_skew_max", 0.0),
                                          skew)
            stats["shard_dispatches"] = stats.get("shard_dispatches", 0) + 1
        L = len(idx) // S
        n_pad = min(L, B // S)
        KEY_LOG.append((S * n_pad, width, use_warm, t == 0))
        return tuple(
            dispatch_sub(d, p, torch.from_numpy(
                idx[s * L:s * L + n_pad].astype(np.int64)).to(dev),
                int(n_vec[s]), t=t, width=width, use_warm=use_warm)
            if n_vec[s] else p
            for s, (d, p, dev) in enumerate(zip(data, state, devices)))

    # one packed transfer per shard and turn for everything the host needs
    current = wait_view(view(state, t % k))
    while t < max_turns:
        done, warm_ok, fills = current
        if bool(done.all()):
            break
        act, width, use_warm = params(done, warm_ok, fills, t, 0)
        state = dispatch(state, act, width, use_warm, t)
        vh = view(state, (t + 1) % k)
        t += 1
        if overlap and t < max_turns:
            # double buffer: dispatch turn t from the now-stale view before
            # waiting on turn t-1's view (vh)
            act_s, width_s, warm_s = params(done, warm_ok, fills, t,
                                            width_growth)
            state = dispatch(state, act_s, width_s, warm_s, t)
            vh2 = view(state, (t + 1) % k)
            t += 1
            if bool(wait_view(vh)[0].all()):
                # the speculated turn ran on an all-done batch: a masked
                # no-op — results are untouched, only the turn counter moved
                break
            current = wait_view(vh2)
        else:
            current = wait_view(vh)
    return state
