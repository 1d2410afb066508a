"""The statistics the metrics are made of: whole-window rates and the
union of intervals behind the device's busy time."""

from __future__ import annotations

from typing import Iterable, List, Tuple


def rate(count: float, seconds: float) -> float:
    """Work per second over the whole window: all of it over all of it."""
    if seconds <= 0:
        raise ValueError(f"window of {seconds} s")
    return count / seconds


def merge(intervals: Iterable[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """The union of ``(start, end)`` intervals as disjoint sorted ones."""
    out: List[Tuple[float, float]] = []
    for s, e in sorted(intervals):
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


def union_length(intervals: Iterable[Tuple[float, float]], lo: float,
                 hi: float) -> float:
    """The length of the union of ``intervals`` clipped to ``[lo, hi]``."""
    clipped = ((max(s, lo), min(e, hi)) for s, e in intervals)
    return sum(e - s for s, e in merge(clipped))


def gaps(intervals: Iterable[Tuple[float, float]], lo: float,
         hi: float) -> List[Tuple[float, float]]:
    """The stretches of ``[lo, hi]`` that no interval covers."""
    out, at = [], lo
    for s, e in merge((max(s, lo), min(e, hi)) for s, e in intervals):
        if s > at:
            out.append((at, s))
        at = max(at, e)
    if hi > at:
        out.append((at, hi))
    return out
