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
  live set rounds up to a multiple of 4 and pads with the out-of-range
  index B.  JAX gathers such an index as a zero-filled row and drops it on
  scatter; torch would raise, so :func:`take_instances` gathers with a
  clamped index and zero-fills the pad rows, and :func:`put_instances`
  scatters back only the live prefix — the same semantics;
* **double buffering** (``overlap=True``) — turn t+1 is dispatched from the
  one-turn-stale view before the host waits on turn t's view.

``KEY_LOG`` records every compacted dispatch's launch shape
``(n_pad, width, use_warm, first_turn)`` exactly as the JAX loop records
its compile keys; the session pool appends its one pinned shape.  Sharded
dispatch (``shard_skew``/``balanced_index``) comes with a later slice.
"""

from __future__ import annotations

from typing import Callable, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.engine.state import _round_up

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


def tree_map(fn: Callable, *trees):
    """Apply ``fn`` leaf-wise over NamedTuple records of tensors."""
    if isinstance(trees[0], tuple):
        return type(trees[0])(*(tree_map(fn, *leaves)
                                for leaves in zip(*trees)))
    return fn(*trees)


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


def wait_view(pending: PendingView) -> np.ndarray:
    """Wait for a started view and return it as a (3, B) numpy array."""
    if pending.ready is not None:
        pending.ready.synchronize()
    return pending.host.numpy()


def run_hot(
    state,
    *,
    k: int,
    max_turns: int,
    cap: int,
    host_view: Callable,      # (state, ci) -> (3, B) i32 [done, warm, fill]
    dispatch_full: Callable,  # (state, *, t, width, use_warm) -> state
    dispatch_sub: Callable,   # (state, idx, n_act, *, t, width, use_warm)
    warm: bool = False,
    compact: bool = True,
    width_slack: int = 0,
    width_growth: int = 0,
    width_policy: str = "linear",
    overlap: bool = False,
):
    """The generic host-driven sweep loop over a selector's ``step``.

    ``host_view`` returns the packed per-turn host knowledge on the state's
    device: row 0 done flags, row 1 the upcoming coordinator's warm-latch
    flags (zero for MEDIAN), row 2 the transcript fills the width
    compaction keys on; it crosses to the host once per turn.  With
    ``warm`` a dispatch gets ``use_warm=True`` from turn 1 on whenever a
    live instance's warm flag is set: polish only where it can latch.
    ``width_slack`` widens the compacted read past the turn-start fill
    (MEDIAN's stage-5 scan reads transcripts after the S append).
    ``width_policy`` picks the :func:`quantize_width` rule.
    ``dispatch_full`` runs the whole batch at a compacted
    ``width`` (``None`` on the non-compacted path); ``dispatch_sub``
    gathers the ``idx`` rows, steps them and scatters them back in place.

    The loop owns its state chain: it copies the caller's state once on
    entry, so sub-batch turns may scatter into it in place.

    ``overlap=True`` dispatches turn t+1 from the one-turn-stale view
    before waiting on turn t's view.  Stale parameters are sound: ``done``
    is monotone, so the stale active set is a superset whose extra rows are
    masked no-ops, and the stale fill plus ``width_growth`` covers the true
    fill.  MEDIAN stays bit-exact; a warm selector may make other, equally
    valid, polish-skip choices (the solver re-checks its warm gate).  At
    most one wasted all-done masked dispatch runs at termination.
    """
    B = int(state.done.shape[0])
    device = state.done.device
    pad_tail = np.full(B, B, dtype=np.int64)
    # turn is per-instance; a sweep advances every row in lock-step, so the
    # host-side loop counter resumes from the common (max) value
    t = int(state.turn.max())
    state = tree_map(torch.clone, state)

    def view(s, ci) -> PendingView:
        return start_view(host_view(s, ci))

    if not compact:
        while t < max_turns:
            done, warm_ok, _fills = wait_view(view(state, t % k))
            if bool(done.all()):
                break
            act = np.flatnonzero(done == 0)
            use_warm = warm and t > 0 and bool(warm_ok[act].any())
            state = dispatch_full(state, t=t, width=None, use_warm=use_warm)
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
        n_act = len(act)
        if n_act == B:
            KEY_LOG.append((B, width, use_warm, t == 0))
            return dispatch_full(state, t=t, width=width, use_warm=use_warm)
        n_pad = min(B, _round_up(n_act, BATCH_MULT))
        idx = np.concatenate([act, pad_tail[:n_pad - n_act]])
        KEY_LOG.append((n_pad, width, use_warm, t == 0))
        return dispatch_sub(state, torch.from_numpy(idx).to(device), n_act,
                            t=t, width=width, use_warm=use_warm)

    # one packed transfer per turn for everything the host needs
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
