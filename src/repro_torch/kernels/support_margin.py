"""The support-margin scans of the turn loops: CUDA kernels, wrappers and
plain PyTorch versions.

* MEDIAN's stage-5 per-node extremes scan, :func:`median_extremes`
  (``csrc/median_extremes.cu``), replaces the TPU kernel
  ``src/repro/kernels/support_margin.py`` ``median_extremes_batched``;
  both versions form the projection as ``(x0*v0) + (x1*v1)``.  Its
  two-segment form :func:`median_extremes_segments` reads each node's own
  rows and its transcript where they lie, as MEDIAN's step calls it.
* MAXMARG's fused turn scan, :func:`maxmarg_turn_scan`
  (``csrc/maxmarg_turn.cu``), replaces ``maxmarg_turn_scan_batched``;
  both versions form every margin with
  :func:`repro_torch.core.geometry.decide`, never with a matrix product.
* The bulk scans over a sweep's state: the consistent-threshold ranges
  :func:`threshold_ranges` (``csrc/threshold_ranges.cu``) and the
  set-of-uncertainty membership :func:`uncertain_mask`
  (``csrc/uncertain_mask.cu``) replace ``threshold_ranges_batched`` and
  ``uncertain_mask_batched``, and as B=1 calls
  (:func:`threshold_ranges_one`, :func:`uncertain_mask_one`) the
  single-instance ``threshold_ranges`` and ``uncertain_mask``; both
  versions project with :func:`repro_torch.core.geometry.project`.

Each rounds once per operation, and each returns integers, booleans or
maxima and minima of projections only, so kernel and plain version agree
exactly.  The CUDA sources' notes give the bounds
on an H100 and the designs.  The wrappers' argument checks are plain
functions (:func:`check_extremes_args`, :func:`check_turn_args`,
:func:`check_ranges_args`, :func:`check_uncertain_args`), and
:func:`extremes_occupancy`, :func:`turn_occupancy`,
:func:`ranges_occupancy` and :func:`uncertain_occupancy` report how a
kernel spreads a call over the card.  A wrapper launches its kernel for
CUDA tensors (bound once, on the current stream's raw handle:
:func:`._build.launch`)
and takes the plain version only for tensors on the CPU.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple, Tuple

import numpy as np
import torch

from repro_torch.core.geometry import decide, project, project_each
from repro_torch.kernels import _build
from repro_torch.kernels.median_cut import _require, plain_chunks

_MAX_TURN_D = 4096      # w sits in shared memory: 4 bytes a feature
_MAX_SCAN_D = 64        # the bulk scans stage d floats per thread


def median_extremes_plain(
    v: torch.Tensor,    # (B, d) f32 per-instance proposed directions
    XW: torch.Tensor,   # (B, k, nW, d) f32 own ∪ fill-capped transcripts
    yW: torch.Tensor,   # (B, k, nW) i32 ±1, 0 = padding
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per node, the first-index argmax of the projection on v over +1 rows
    (``i_p``) and the first-index argmin over -1 rows (``i_q``), each (B, k)
    int32; index 0 where the class is absent."""
    pj = project_each(XW, v)
    i_p = pj.masked_fill(yW != 1, -math.inf).argmax(dim=2)
    i_q = pj.masked_fill(yW != -1, math.inf).argmin(dim=2)
    return i_p.to(torch.int32), i_q.to(torch.int32)


class Extremes(NamedTuple):
    """Stage 5's extremes per (instance, node), each (B, k) unless noted."""
    i_p: torch.Tensor     # i32 first argmax row over +1 rows, 0 if none
    i_q: torch.Tensor     # i32 first argmin row over -1 rows, 0 if none
    has_p: torch.Tensor   # bool: some +1 row
    has_q: torch.Tensor   # bool: some -1 row
    p: torch.Tensor       # (B, k, 2) f32 row i_p
    q: torch.Tensor       # (B, k, 2) f32 row i_q
    lo: torch.Tensor      # f32 p's projection on v, -inf without has_p
    hi: torch.Tensor      # f32 q's projection on v, +inf without has_q


def median_extremes_segments_plain(
    v: torch.Tensor,    # (B, 2) f32 per-instance proposed directions
    X: torch.Tensor,    # (B, k, n, 2) f32 own rows
    y: torch.Tensor,    # (B, k, n) i32 ±1, 0 = padding
    wx: torch.Tensor,   # (B, k, cap, 2) f32 transcripts
    wy: torch.Tensor,   # (B, k, cap) i32
    width: int,         # transcript rows read, <= cap
) -> Extremes:
    """:func:`median_extremes_plain` over each node's own rows followed by
    the first ``width`` rows of its transcript (the rows numbered as that
    concatenation), with the chosen rows, whether each class is present and
    the band edges beside the indices."""
    XW = torch.cat([X, wx[:, :, :width]], dim=2)
    yW = torch.cat([y, wy[:, :, :width]], dim=2)
    i_p, i_q = median_extremes_plain(v, XW, yW)
    has_p = (yW == 1).any(dim=2)
    has_q = (yW == -1).any(dim=2)
    rows = (torch.arange(XW.shape[0], device=XW.device)[:, None],
            torch.arange(XW.shape[1], device=XW.device)[None, :])
    p, q = XW[rows + (i_p.long(),)], XW[rows + (i_q.long(),)]
    lo = torch.where(has_p, project_each(p, v), -math.inf)
    hi = torch.where(has_q, project_each(q, v), math.inf)
    return Extremes(i_p, i_q, has_p, has_q, p, q, lo, hi)


def check_extremes_args(v, X, y, wx=None, wy=None, width=0):
    """Raise unless the kernel takes these inputs: f32 v (B, 2), X
    (B, k, n, 2) and int32 y (B, k, n); with a transcript, f32 wx
    (B, k, cap, 2) and int32 wy (B, k, cap), 0 <= width <= cap; one device,
    contiguous, v, X and wx 8-byte aligned, and at least one row.  Returns
    (B, k, n, cap)."""
    B, k, n = y.shape
    cap = 0 if wy is None else wy.shape[2]
    if B * k == 0 or not 0 <= width <= cap or n + width == 0:
        raise ValueError(f"median_extremes: unsupported shape B={B}, k={k}, "
                         f"n={n}, cap={cap}, width={width}")
    dev, f32 = X.device, torch.float32
    _require(v, "v", f32, (B, 2), dev)
    _require(X, "X", f32, (B, k, n, 2), dev)
    _require(y, "y", torch.int32, (B, k, n), dev)
    if wy is not None:
        _require(wx, "wx", f32, (B, k, cap, 2), dev)
        _require(wy, "wy", torch.int32, (B, k, cap), dev)
    if any(t.data_ptr() % 8 for t in (v, X) + (() if wx is None else (wx,))):
        raise ValueError("median_extremes: v, X and wx must be 8-byte "
                         "aligned (the kernel reads points as pairs)")
    return B, k, n, cap


_EXTREMES_ARGS = [ctypes.c_void_p] * 13 + [ctypes.c_int] * 5 + \
    [ctypes.c_void_p]


def _extremes_launch(v, X, y, wx, wy, width, full):
    """Launch the extremes kernel; ``full``: all of :class:`Extremes`,
    else (i_p, i_q)."""
    B, k, n, cap = check_extremes_args(v, X, y, wx, wy, width)
    dev = X.device
    i_p = torch.empty((B, k), dtype=torch.int32, device=dev)
    i_q = torch.empty((B, k), dtype=torch.int32, device=dev)
    rest = ()
    if full:
        rest = (torch.empty((B, k), dtype=torch.bool, device=dev),
                torch.empty((B, k), dtype=torch.bool, device=dev),
                torch.empty((B, k, 2), device=dev),
                torch.empty((B, k, 2), device=dev),
                torch.empty((B, k), device=dev),
                torch.empty((B, k), device=dev))
    lib, fn = _build.bind("median_extremes", "median_extremes_launch",
                          _EXTREMES_ARGS)
    err = _build.launch(
        fn, dev, *(None if t is None else t.data_ptr()
                   for t in (v, X, y, wx, wy, i_p, i_q)
                   + (rest or (None,) * 6)), B, k, n, cap, width)
    _build.check(lib, "median_extremes", err)
    median_extremes.launches += 1
    return Extremes(i_p, i_q, *rest) if full else (i_p, i_q)


def median_extremes(v, XW, yW) -> Tuple[torch.Tensor, torch.Tensor]:
    """The extremes scan of :func:`median_extremes_plain`.  CUDA tensors
    launch the kernel of ``csrc/median_extremes.cu`` (and count the launch
    in ``median_extremes.launches``); CPU tensors take the plain version.
    The one-segment case of :func:`median_extremes_segments`."""
    if XW.device.type == "cpu":
        return median_extremes_plain(v, XW, yW)
    if XW.device.type != "cuda":
        raise ValueError(f"median_extremes runs on cuda or cpu, "
                         f"not {XW.device}")
    return _extremes_launch(v, XW, yW, None, None, 0, full=False)


def median_extremes_segments(v, X, y, wx, wy, width: int) -> Extremes:
    """The extremes of :func:`median_extremes_segments_plain`, read from
    the two segments where they lie: CUDA tensors launch the kernel of
    ``csrc/median_extremes.cu`` (counted in ``median_extremes.launches``),
    CPU tensors take the plain version."""
    if X.device.type == "cpu":
        return median_extremes_segments_plain(v, X, y, wx, wy, width)
    if X.device.type != "cuda":
        raise ValueError(f"median_extremes runs on cuda or cpu, "
                         f"not {X.device}")
    return _extremes_launch(v, X, y, wx, wy, width, full=True)


def extremes_occupancy(rows: int) -> Tuple[int, int]:
    """(warps the kernel gives each of ``rows`` row blocks, its blocks
    resident on one SM of the current card)."""
    _, fn = _build.bind("median_extremes", "median_extremes_occupancy",
                        [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p])
    team, blocks = ctypes.c_int(0), ctypes.c_int(0)
    err = fn(rows, ctypes.byref(team), ctypes.byref(blocks))
    _build.check(_build.load("median_extremes"), "median_extremes", err)
    return team.value, blocks.value


median_extremes.launches = 0


def _topr_ranks(key: torch.Tensor, member: torch.Tensor, r: int):
    """Along the last axis, the rank of the ``r`` smallest member entries
    under ascending (key, index) order; every other entry gets the sentinel
    (the axis length).  ``r`` rounds of a first-index argmin, as the JAX
    package's ``ref._topr_ranks`` spells it; members with key +inf are
    never ranked."""
    n = key.shape[-1]
    k2 = key.masked_fill(~member, math.inf)
    out = torch.full(key.shape, n, dtype=torch.int32, device=key.device)
    for t in range(r):
        i = k2.argmin(dim=-1, keepdim=True)              # first minimum
        hit = torch.isfinite(k2.gather(-1, i))
        out.scatter_(-1, i, torch.where(hit, t, out.gather(-1, i)))
        k2 = k2.scatter(-1, i, torch.where(hit, math.inf, k2.gather(-1, i)))
    return out


def maxmarg_turn_scan_plain(
    w: torch.Tensor,    # (B, d) f32 per-instance refit separators
    b: torch.Tensor,    # (B,) f32
    K: torch.Tensor,    # (B, N, d) f32 own ∪ transcript fit sets
    yK: torch.Tensor,   # (B, N) i32 ±1, 0 = padding
    X: torch.Tensor,    # (B, k, n, d) f32 per-node shards
    y: torch.Tensor,    # (B, k, n) i32 ±1, 0 = padding
    *,
    rtol: float = 0.15,
    max_support: int = 4,
    viol_ship: int = 2,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One MAXMARG turn's fused margin scan, integer outputs only:

    * ``sup_rank`` (B, N) i32 — the (margin, index) rank of the
      ``max_support`` tightest fit-set rows within the active-margin band
      (margin ≤ max(min margin, 1e-12)·(1+rtol)), sentinel N elsewhere;
    * ``err_k`` (B, k) i32 — per-node error counts of the proposal;
    * ``viol_rank`` (B, k, n) i32 — per node, the (margin, index) rank of
      the ``viol_ship`` most-violated valid rows, sentinel n elsewhere.

    The JAX package's ``ref.maxmarg_turn_batch_ref``, with every margin
    formed by :func:`~repro_torch.core.geometry.decide`."""
    valid_K = yK != 0
    mK = yK.to(K.dtype) * decide(K, w, b)
    mmin = mK.masked_fill(~valid_K, math.inf).amin(dim=1).clamp_min(1e-12)
    scale = torch.tensor(1.0 + rtol, dtype=K.dtype)      # rounded to f32 once
    band = valid_K & (mK <= (mmin * scale)[:, None])
    sup_rank = _topr_ranks(mK, band, max_support)

    dec = decide(X, w, b)                                # (B, k, n)
    valid = y != 0
    pred = torch.where(dec > 0, 1, -1)
    err_k = ((pred != y) & valid).sum(dim=2, dtype=torch.int32)
    viol_rank = _topr_ranks(y.to(X.dtype) * dec, valid, viol_ship)
    return sup_rank, err_k, viol_rank


def check_turn_args(w, b, K, yK, X, y, max_support=4, viol_ship=2):
    """Raise unless the kernel takes these inputs: f32 w (B, d), b (B,),
    K (B, N, d) and X (B, k, n, d), int32 yK (B, N) and y (B, k, n), on one
    device and contiguous, with 0 < d <= ``_MAX_TURN_D``, at least one
    instance, fit-set row, node and shard row, and max_support, viol_ship
    >= 0; for d = 2, w, K and X 8-byte aligned.  Returns (B, N, k, n, d)."""
    B, N, d = K.shape
    k, n = y.shape[1], y.shape[2]
    if not (B > 0 and N > 0 and k > 0 and n > 0 and 0 < d <= _MAX_TURN_D
            and max_support >= 0 and viol_ship >= 0):
        raise ValueError(f"maxmarg_turn_scan: unsupported shape B={B}, "
                         f"N={N}, k={k}, n={n}, d={d}, max_support="
                         f"{max_support}, viol_ship={viol_ship}")
    dev, f32 = K.device, torch.float32
    _require(w, "w", f32, (B, d), dev)
    _require(b, "b", f32, (B,), dev)
    _require(K, "K", f32, (B, N, d), dev)
    _require(yK, "yK", torch.int32, (B, N), dev)
    _require(X, "X", f32, (B, k, n, d), dev)
    _require(y, "y", torch.int32, (B, k, n), dev)
    if d == 2 and any(t.data_ptr() % 8 for t in (w, K, X)):
        raise ValueError("maxmarg_turn_scan: w, K and X must be 8-byte "
                         "aligned at d = 2 (the kernel reads points as "
                         "pairs)")
    return B, N, k, n, d


_TURN_ARGS = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 5 + \
    [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]


def maxmarg_turn_scan(w, b, K, yK, X, y, *, rtol=0.15, max_support=4,
                      viol_ship=2):
    """The turn scan of :func:`maxmarg_turn_scan_plain`.  CUDA tensors launch
    the kernel of ``csrc/maxmarg_turn.cu`` (and count the launch in
    ``maxmarg_turn_scan.launches``); CPU tensors take the plain version."""
    opts = dict(rtol=rtol, max_support=max_support, viol_ship=viol_ship)
    if K.device.type == "cpu":
        return maxmarg_turn_scan_plain(w, b, K, yK, X, y, **opts)
    if K.device.type != "cuda":
        raise ValueError(f"maxmarg_turn_scan runs on cuda or cpu, "
                         f"not {K.device}")
    B, N, k, n, d = check_turn_args(w, b, K, yK, X, y, max_support,
                                    viol_ship)
    dev = K.device
    sup_rank = torch.empty((B, N), dtype=torch.int32, device=dev)
    err_k = torch.empty((B, k), dtype=torch.int32, device=dev)
    viol_rank = torch.empty((B, k, n), dtype=torch.int32, device=dev)
    lib, fn = _build.bind("maxmarg_turn", "maxmarg_turn_launch", _TURN_ARGS)
    err = _build.launch(
        fn, dev, w.data_ptr(), b.data_ptr(), K.data_ptr(), yK.data_ptr(),
        X.data_ptr(), y.data_ptr(), sup_rank.data_ptr(), err_k.data_ptr(),
        viol_rank.data_ptr(), B, N, k, n, d, float(np.float32(1.0 + rtol)),
        max_support, viol_ship)
    _build.check(lib, "maxmarg_turn", err)
    maxmarg_turn_scan.launches += 1
    return sup_rank, err_k, viol_rank


def turn_occupancy(B, N, k, n, d, max_support=4, viol_ship=2
                   ) -> Tuple[int, int, int]:
    """(warps the turn kernel gives each segment, its register list's
    capacity, its blocks resident on one SM of the current card) for these
    shapes."""
    _, fn = _build.bind("maxmarg_turn", "maxmarg_turn_occupancy",
                        [ctypes.c_int] * 7 + [ctypes.c_void_p] * 3)
    team, cap, blocks = ctypes.c_int(0), ctypes.c_int(0), ctypes.c_int(0)
    err = fn(B, N, k, n, d, max_support, viol_ship, ctypes.byref(team),
             ctypes.byref(cap), ctypes.byref(blocks))
    _build.check(_build.load("maxmarg_turn"), "maxmarg_turn", err)
    return team.value, cap.value, blocks.value


maxmarg_turn_scan.launches = 0


def threshold_ranges_plain(
    V: torch.Tensor,    # (m, d) f32 shared directions
    Xw: torch.Tensor,   # (B, n, d) f32 transcripts
    yw: torch.Tensor,   # (B, n) i32 ±1, 0 = empty/padding
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per instance and direction, the consistent-threshold interval
    ``(lo, hi)`` = (max over +1 rows of v·x, min over -1 rows), each (B, m)
    f32; -inf / +inf where the class is absent, label-0 rows inert.  The
    JAX package's ``ref.threshold_ranges_batch_ref``, projected by
    :func:`~repro_torch.core.geometry.project`, in chunks of instances."""
    B, m = Xw.shape[0], V.shape[0]
    if Xw.shape[1] == 0:
        return (torch.full((B, m), -math.inf, device=Xw.device),
                torch.full((B, m), math.inf, device=Xw.device))

    def chunk(Xc, yc):
        proj = project(V, Xc)                                # (b, m, n)
        lo = proj.masked_fill(~(yc == 1)[:, None, :], -math.inf).amax(dim=2)
        hi = proj.masked_fill(~(yc == -1)[:, None, :], math.inf).amin(dim=2)
        return lo, hi

    parts = [chunk(*a) for a in plain_chunks(m * Xw.shape[1], Xw, yw)]
    return (torch.cat([p[0] for p in parts]),
            torch.cat([p[1] for p in parts]))


def check_ranges_args(V, Xw, yw):
    """Raise unless the kernel takes these inputs: f32 V (m, d), f32 Xw
    (B, n, d) and int32 yw (B, n), on one device and contiguous, with
    B, m > 0 and 0 < d <= ``_MAX_SCAN_D``; for d = 2, V and Xw 8-byte
    aligned.  Returns (B, m, n, d)."""
    (m, d), (B, n) = V.shape, yw.shape
    if not (B > 0 and m > 0 and 0 < d <= _MAX_SCAN_D):
        raise ValueError(f"threshold_ranges: unsupported shape B={B}, "
                         f"m={m}, n={n}, d={d}")
    dev = Xw.device
    _require(V, "V", torch.float32, (m, d), dev)
    _require(Xw, "Xw", torch.float32, (B, n, d), dev)
    _require(yw, "yw", torch.int32, (B, n), dev)
    if d == 2 and any(t.data_ptr() % 8 for t in (V, Xw)):
        raise ValueError("threshold_ranges: V and Xw must be 8-byte aligned "
                         "at d = 2 (the kernel reads points and directions "
                         "as pairs)")
    return B, m, n, d


class RangesSplit(NamedTuple):
    """How the ranges kernel spreads a call (``csrc/threshold_ranges.cu``):
    ``warps`` warps make a row group (a block's 8 // warps groups split
    an instance's rows), a thread takes ``per_thread`` consecutive
    directions, an instance's directions are split over ``tiles`` blocks,
    ``chunk`` transcript rows are staged in shared memory at a time, a
    block stages ``per_block`` instances together (their labels read at
    once, their points copied at once), and ``per_sm`` blocks are resident
    on one SM (at the largest chunk and ``per_block``)."""
    warps: int
    per_thread: int
    tiles: int
    chunk: int
    per_sm: int
    per_block: int = 1


# (warps a row group, directions a thread), widest tile first; at d = 2
# and 3 the directions sit in registers, four a thread
_RANGES_LADDER = ((8, 4), (4, 4), (2, 4), (1, 4), (1, 1))
_RANGES_LADDER_ANY_D = ((8, 1), (4, 1), (2, 1), (1, 1))
_RANGES_MAX_CHUNK = 1024     # rows: 256 threads read 4 labels each
_RANGES_STAGE_FLOATS = 4096  # 16 KB a buffer of staged rows, two buffers
_RANGES_MAX_BATCH = 3        # instances a block stages together, at most
_RANGES_RESIDENCY = {}       # d -> (SMs, blocks an SM)


def ranges_chunk(d: int, n: int = _RANGES_MAX_CHUNK) -> int:
    """Transcript rows the ranges kernel stages at a time: as many as 16 KB
    holds (a row padded to 2 floats at d = 2, else to a multiple of 4), at
    most 1024, a multiple of 4, and no more than n needs."""
    xs = 2 if d == 2 else 4 * -(-d // 4)
    cap = min(_RANGES_MAX_CHUNK, _RANGES_STAGE_FLOATS // xs // 4 * 4)
    return max(4, min(cap, -(-n // 4) * 4))


def _ranges_residency(d: int, per_thread: int) -> Tuple[int, int]:
    """(SMs, blocks of the kernel for d and per_thread resident on one SM)
    of the current card, read once for each d."""
    got = _RANGES_RESIDENCY.get(d)
    if got is None:
        _, fn = _build.bind("threshold_ranges", "threshold_ranges_residency",
                            [ctypes.c_int] * 4 + [ctypes.c_void_p])
        blocks = ctypes.c_int(0)
        err = fn(d, per_thread, ranges_chunk(d), _RANGES_MAX_BATCH,
                 ctypes.byref(blocks))
        _build.check(_build.load("threshold_ranges"), "threshold_ranges",
                     err)
        sms = torch.cuda.get_device_properties(
            torch.cuda.current_device()).multi_processor_count
        got = _RANGES_RESIDENCY[d] = (sms, blocks.value)
    return got


@functools.lru_cache(maxsize=1024)
def _ranges_split(B, m, n, d, sms, per_sm) -> RangesSplit:
    ladder = _RANGES_LADDER if d in (2, 3) else _RANGES_LADDER_ANY_D
    # tiles at most twice m (more than half a tile idle otherwise)
    fit = [s for s in ladder if 32 * s[0] * s[1] < 2 * m] or [ladder[-1]]
    slots = sms * per_sm
    for warps, per_thread in fit:
        tiles = -(-m // (32 * warps * per_thread))
        if B * tiles >= slots:
            break
    chunk = ranges_chunk(d, n)
    # blocks beyond one wave take several instances each (one chunk each)
    per_block = (min(_RANGES_MAX_BATCH, -(-B * tiles // slots))
                 if n <= chunk else 1)
    return RangesSplit(warps, per_thread, tiles, chunk, per_sm, per_block)


def ranges_occupancy(B: int, m: int, n: int, d: int, *, sms: int = None,
                     per_sm: int = None) -> RangesSplit:
    """The split of a ranges call: the widest direction tile whose blocks
    (B × tiles) fill the card once, ``sms`` × ``per_sm`` blocks, else the
    narrowest (32 directions, 8 row groups of a warp); tiles wider than
    twice m are passed over.  Where the blocks would fill the card more
    than once and the transcripts fit one chunk, a block stages up to three
    instances together.  Given ``sms`` and ``per_sm``, a pure function of
    its arguments; they default to the current card's, read once."""
    if sms is None or per_sm is None:
        ladder = _RANGES_LADDER if d in (2, 3) else _RANGES_LADDER_ANY_D
        card = _ranges_residency(d, ladder[0][1])
        sms = card[0] if sms is None else sms
        per_sm = card[1] if per_sm is None else per_sm
    return _ranges_split(B, m, n, d, sms, per_sm)


_RANGES_ARGS = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 + \
    [ctypes.c_void_p]


def _ranges_launch(V, Xw, yw, split: RangesSplit = None):
    """Launch the ranges kernel, split by ``split`` (else by
    :func:`ranges_occupancy`); one allocation holds lo and hi."""
    B, m, n, d = check_ranges_args(V, Xw, yw)
    split = split or ranges_occupancy(B, m, n, d)
    out = torch.empty((2, B, m), dtype=torch.float32, device=Xw.device)
    lib, fn = _build.bind("threshold_ranges", "threshold_ranges_launch",
                          _RANGES_ARGS)
    err = _build.launch(fn, Xw.device, V.data_ptr(), Xw.data_ptr(),
                        yw.data_ptr(), out.data_ptr(), B, m, n, d,
                        split.warps, split.per_thread, split.chunk,
                        split.per_block)
    _build.check(lib, "threshold_ranges", err)
    threshold_ranges.launches += 1
    return out[0], out[1]


def threshold_ranges(V, Xw, yw) -> Tuple[torch.Tensor, torch.Tensor]:
    """The ranges of :func:`threshold_ranges_plain`.  CUDA tensors launch
    the kernel of ``csrc/threshold_ranges.cu``, split by
    :func:`ranges_occupancy` (and count the launch in
    ``threshold_ranges.launches``); CPU tensors take the plain version."""
    if Xw.device.type == "cpu":
        return threshold_ranges_plain(V, Xw, yw)
    if Xw.device.type != "cuda":
        raise ValueError(f"threshold_ranges runs on cuda or cpu, "
                         f"not {Xw.device}")
    return _ranges_launch(V, Xw, yw)


threshold_ranges.launches = 0


def threshold_ranges_one(V, Xw, yw) -> Tuple[torch.Tensor, torch.Tensor]:
    """The single-instance ranges, (m, d) × (n, d) × (n,) -> (m,) ×2: a B=1
    call of :func:`threshold_ranges`."""
    lo, hi = threshold_ranges(V, Xw[None], yw[None])
    return lo[0], hi[0]


def uncertain_mask_plain(
    V: torch.Tensor,        # (m, d) f32 shared directions
    dir_ok: torch.Tensor,   # (B, m) bool
    lo: torch.Tensor,       # (B, m) f32
    hi: torch.Tensor,       # (B, m) f32
    X: torch.Tensor,        # (B, n, d) f32
    y: torch.Tensor,        # (B, n) i32 ±1 (label-0 rows take the -1 test)
) -> torch.Tensor:
    """(B, n) bool set-of-uncertainty membership: whether some allowed
    direction with lo < hi puts the point at risk (+1: v·x > lo; else
    v·x < hi).  The JAX package's ``ref.uncertain_mask_batch_ref``,
    projected by :func:`~repro_torch.core.geometry.project`, in chunks of
    instances."""
    nonempty = (lo < hi) & dir_ok

    def chunk(ne, lo_c, hi_c, Xc, yc):
        proj = project(V, Xc)                                # (b, m, n)
        risk = torch.where((yc == 1)[:, None, :], proj > lo_c[:, :, None],
                           proj < hi_c[:, :, None])
        return (risk & ne[:, :, None]).any(dim=1)

    return torch.cat([chunk(*a) for a in plain_chunks(
        V.shape[0] * X.shape[1], nonempty, lo, hi, X, y)])


def check_uncertain_args(V, dir_ok, lo, hi, X, y):
    """Raise unless the kernel takes these inputs: f32 V (m, d), bool dir_ok
    (B, m), f32 lo and hi (B, m), f32 X (B, n, d) and int32 y (B, n), on one
    device and contiguous, with B, m > 0 and 0 < d <= ``_MAX_SCAN_D``; for
    d = 2, V and X 8-byte aligned.  Returns (B, m, n, d)."""
    (m, d), (B, n) = V.shape, y.shape
    if not (B > 0 and m > 0 and 0 < d <= _MAX_SCAN_D):
        raise ValueError(f"uncertain_mask: unsupported shape B={B}, m={m}, "
                         f"n={n}, d={d}")
    dev = X.device
    _require(V, "V", torch.float32, (m, d), dev)
    _require(dir_ok, "dir_ok", torch.bool, (B, m), dev)
    _require(lo, "lo", torch.float32, (B, m), dev)
    _require(hi, "hi", torch.float32, (B, m), dev)
    _require(X, "X", torch.float32, (B, n, d), dev)
    _require(y, "y", torch.int32, (B, n), dev)
    if d == 2 and any(t.data_ptr() % 8 for t in (V, X)):
        raise ValueError("uncertain_mask: V and X must be 8-byte aligned at "
                         "d = 2 (the kernel reads points and directions as "
                         "pairs)")
    return B, m, n, d


_UNCERTAIN_ARGS = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + \
    [ctypes.c_void_p]


def uncertain_mask(V, dir_ok, lo, hi, X, y) -> torch.Tensor:
    """The membership of :func:`uncertain_mask_plain`.  CUDA tensors launch
    the kernel of ``csrc/uncertain_mask.cu`` (and count the launch in
    ``uncertain_mask.launches``); CPU tensors take the plain version."""
    if X.device.type == "cpu":
        return uncertain_mask_plain(V, dir_ok, lo, hi, X, y)
    if X.device.type != "cuda":
        raise ValueError(f"uncertain_mask runs on cuda or cpu, "
                         f"not {X.device}")
    B, m, n, d = check_uncertain_args(V, dir_ok, lo, hi, X, y)
    out = torch.empty((B, n), dtype=torch.bool, device=X.device)
    if n == 0:
        return out
    lib, fn = _build.bind("uncertain_mask", "uncertain_mask_launch",
                          _UNCERTAIN_ARGS)
    err = _build.launch(fn, X.device, V.data_ptr(), dir_ok.data_ptr(),
                        lo.data_ptr(), hi.data_ptr(), X.data_ptr(),
                        y.data_ptr(), out.data_ptr(), B, m, n, d)
    _build.check(lib, "uncertain_mask", err)
    uncertain_mask.launches += 1
    return out


def uncertain_occupancy(B, m, n, d) -> Tuple[int, int, int]:
    """(blocks the SOU kernel splits each instance's points over, the
    directions one chunk of its shared memory holds, its blocks resident on
    one SM of the current card) for these shapes."""
    _, fn = _build.bind("uncertain_mask", "uncertain_mask_occupancy",
                        [ctypes.c_int] * 4 + [ctypes.c_void_p] * 3)
    parts, cap, blocks = ctypes.c_int(0), ctypes.c_int(0), ctypes.c_int(0)
    err = fn(B, m, n, d, ctypes.byref(parts), ctypes.byref(cap),
             ctypes.byref(blocks))
    _build.check(_build.load("uncertain_mask"), "uncertain_mask", err)
    return parts.value, cap.value, blocks.value


uncertain_mask.launches = 0


def uncertain_mask_one(V, dir_ok, lo, hi, X, y) -> torch.Tensor:
    """The single-instance membership, (m,) bounds and (n, d) points ->
    (n,) bool: a B=1 call of :func:`uncertain_mask`."""
    return uncertain_mask(V, dir_ok[None], lo[None], hi[None], X[None],
                          y[None])[0]
