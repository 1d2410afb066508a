"""The card's figures, each kernel's work and the timers behind every bound.

One home for what a kernel's bound is made of, so that ``chip_smoke.py``,
the dry-run planner (:mod:`.roofline`, :mod:`.plan_cost`), the FLOP
formulas of :mod:`repro_torch.kernels._ops` and the tile tuner
(:mod:`.autotune`) count the same thing:

* the H100's data-sheet figures (SXM part, dense rates, at its 700 W
  limit), one definition each;
* a work function per kernel, returning :class:`Work` ``(bytes, ops,
  exps)`` for one call from its inputs: each input read once, each output
  written once, and the operations this call's data needs (live rows
  only where the kernel skips padding):

  - cut scan: 3 per live point and direction;
  - extremes scan: 3 per live row;
  - turn scan: 2d + 2 + max_support per valid fit-set row and 2d + 2 +
    viol_ship per valid shard row;
  - Pegasos stage: (nsteps + 1) · valid rows · (2d + 2);
  - ranges and set-of-uncertainty scans: 2d per tested (row, direction);
  - attention: 4 · hd per kept (query, key) pair;
  - WKV: 5 · n · hd · (hd + 1) over n (batch row, step, head) triples;
  - selective scan: 6 per (step, channel, state) and one exponential
    (:func:`scan_ops`, the recurrence the planner counts), and 1 per
    (step, channel);

* the bound of a call (:func:`bound_ms`): the larger of its bytes over the
  HBM rate and its operations over the peak of their type, the
  exponentials split between the special-function units and FMA-pipe
  polynomials so that both finish together (:func:`ops_ms`);
* the timers: :func:`median_ms` (CUDA events around single calls) and
  :func:`graph_ms` (device time: calls captured in a CUDA graph on a side
  stream, the median over replays).

Nothing here touches a card at import; the timers need one.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Sequence

import numpy as np

# NVIDIA H100 80GB HBM3, 700 W (data sheet, SXM, dense)
PEAK_F32 = 67e12              # FLOP/s outside the tensor cores
PEAK_FLOPS_BF16 = 989e12      # FLOP/s on the tensor cores
HBM_BW = 3.35e12              # bytes/s
NVLINK_BW = 450e9             # bytes/s each way
CHIP_HBM_BYTES = 80e9         # bytes
SMEM_PER_BLOCK = 227 * 1024   # dynamic shared memory a block can opt into
# exponentials a second on the special-function units: 16 results a clock
# on each of 132 SMs, at 1.98 GHz, the clock behind the 67 TFLOP/s f32 peak
PEAK_SFU = 132 * 16 * 1.98e9
# an f32 exponential as a polynomial on the FMA pipes instead (Cephes's
# expf form: two adds of range reduction, a degree-5 polynomial in five
# FMAs): 7 issue slots, counted as 14 operations at the f32 rate
POLY_EXP_OPS = 14


class Work(NamedTuple):
    """What one kernel call must do: bytes moved, operations, and f32
    exponentials (counted apart from ``ops``)."""
    bytes: int
    ops: int
    exps: int = 0


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def _count(mask) -> int:
    return int(mask.sum())


# ---------------------------------------------------------------------------
# the protocol kernels (rows 1-8)
# ---------------------------------------------------------------------------

def cut_work(V, dir_ok, lo, hi, X, y, live: Optional[int] = None) -> Work:
    """The cut scan (``median_cut_scores``): every input read once, the
    (B, m) scores written; 2 multiplies and an add per live point (label
    not 0) and direction.  ``live`` may be given where the inputs hold no
    data (meta tensors)."""
    m = V.shape[0]
    live = _count(y != 0) if live is None else int(live)
    return Work(nbytes(V, dir_ok, lo, hi, X, y) + 4 * dir_ok.numel(),
                3 * live * m)


def extremes_work(v, X, y, wx=None, wy=None, width: int = 0) -> Work:
    """The extremes scan: v, the own rows and the transcripts' first
    ``width`` rows read; the two-segment form (a transcript given) writes
    indices, flags, rows and edges (34 bytes a node), the one-segment form
    the indices (8); 3 operations a live row."""
    B, k = y.shape[0], y.shape[1]
    live = _count(y != 0)
    moved = nbytes(v, X, y)
    out = 8
    if wy is not None:
        seg = (wx[:, :, :width], wy[:, :, :width])
        live += _count(seg[1] != 0)
        moved += nbytes(*seg)
        out = 4 + 4 + 1 + 1 + 8 + 8 + 4 + 4
    return Work(moved + out * B * k, 3 * live)


def turn_work(w, b, K, yK, X, y, max_support: int = 4,
              viol_ship: int = 2) -> Work:
    """The turn scan: inputs read once, sup_rank, err_k and viol_rank
    written (int32); per valid fit-set row a margin (2d + 1), the band test
    and a compare in each support round, per valid shard row a margin, the
    error test and a compare in each violation round."""
    B, N, d = K.shape
    k = y.shape[1]
    out = 4 * (B * N + B * k + y.numel())
    return Work(nbytes(w, b, K, yK, X, y) + out,
                (2 * d + 2 + max_support) * _count(yK != 0)
                + (2 * d + 2 + viol_ship) * _count(y != 0))


def pegasos_work(X, y, nv, w, b, lam, found, w_best, b_best, *,
                 nsteps: int) -> Work:
    """A Pegasos stage: inputs read once, (w, b, mmin, w_best, b_best) in
    f32 and found written; every valid row's margin (2d + 1) and hinge test
    at every step and in the final scan.  The gradient of the violating
    rows depends on the iterates and is left out (a lower bound)."""
    B, _, d = X.shape
    out = 4 * (3 * B * d + 3 * B) + B
    return Work(nbytes(X, y, nv, w, b, lam, found, w_best, b_best) + out,
                (nsteps + 1) * _count(y != 0) * (2 * d + 2))


def ranges_work(V, Xw, yw) -> Work:
    """The ranges scan: V and every label read once, the point of each row
    of label ±1 (a label-0 row's point is never needed), lo and hi written;
    2d - 1 operations of projection and a compare per live row and
    direction."""
    B, m, d = yw.shape[0], V.shape[0], V.shape[1]
    live = _count(yw != 0)
    return Work(nbytes(V, yw) + live * Xw.shape[-1] * Xw.element_size()
                + 2 * B * m * 4, 2 * d * live * m)


def uncertain_tests(V, dir_ok, lo, hi, X, y, width: int = 128):
    """``(tests, rounds)`` of the SOU scan on these inputs.  A point is
    projected only onto the directions that are allowed and have lo < hi,
    in grid order up to and including its first risky one (all of them for
    a point that none puts at risk).  ``rounds``: the kernel's rounds of
    ``width`` directions over all points (each point's tests rounded up to
    whole rounds)."""
    import torch

    from repro_torch.core.geometry import project
    from repro_torch.kernels.median_cut import plain_chunks

    m = V.shape[0]
    nonempty = (lo < hi) & dir_ok
    tests = rounds = 0
    for ne, lc, hc, Xc, yc in plain_chunks(m * X.shape[1], nonempty, lo, hi,
                                           X, y):
        proj = project(V, Xc)
        risk = torch.where((yc == 1)[:, None, :], proj > lc[:, :, None],
                           proj < hc[:, :, None]) & ne[:, :, None]
        idx = torch.arange(m, device=X.device)[None, :, None]
        first = torch.where(risk, idx, m - 1).amin(dim=1)       # (b, n)
        upto = torch.cumsum(ne.int(), dim=1)                     # (b, m)
        each = upto.gather(1, first)
        tests += int(each.sum())
        rounds += int(((each + width - 1) // width).sum())
    return tests, rounds


def uncertain_work(V, dir_ok, lo, hi, X, y,
                   tests: Optional[int] = None) -> Work:
    """The SOU scan: every direction's flag and bounds read, a point and
    its label only in an instance with at least one allowed nonempty
    direction (elsewhere the answer is False whatever the point), one byte
    written a point; 2d operations per test (:func:`uncertain_tests`,
    unless ``tests`` is given)."""
    if tests is None:
        tests, _ = uncertain_tests(V, dir_ok, lo, hi, X, y)
    needed = _count(((lo < hi) & dir_ok).any(dim=1))
    point_bytes = X.shape[1] * (X.shape[2] * X.element_size()
                                + y.element_size())
    return Work(nbytes(V, dir_ok, lo, hi) + needed * point_bytes + y.numel(),
                2 * V.shape[1] * tests)


# ---------------------------------------------------------------------------
# the model kernels (rows 9-11): operations from shapes alone
# ---------------------------------------------------------------------------

def kept_pairs(Sq: int, Skv: int, causal: bool,
               window: Optional[int] = None) -> int:
    """(query, key) pairs the mask keeps, queries at 0..Sq-1."""
    i = np.arange(Sq, dtype=np.int64)
    hi = np.minimum(i + 1, Skv) if causal else np.full(Sq, Skv)
    lo = np.maximum(0, i - window + 1) if window is not None else 0
    return int(np.maximum(0, hi - lo).sum())


def attention_ops(q_shape: Sequence[int], Skv: int, causal: bool,
                  window: Optional[int] = None) -> int:
    """4 · hd per kept (query, key) pair of q (B, Sq, H, hd): the score's
    and the output's multiply-adds."""
    B, Sq, H, hd = q_shape
    return 4 * hd * B * H * kept_pairs(Sq, Skv, causal, window)


def attention_work(q, k, v, causal: bool,
                   window: Optional[int] = None) -> Work:
    """Attention: q, k, v read once, the output (q's size) written."""
    return Work(nbytes(q, k, v, q),
                attention_ops(q.shape, k.shape[1], causal, window))


def wkv_ops(B: int, S: int, H: int, hd: int) -> int:
    """The WKV recurrence over B · S · H (batch row, step, head) triples of
    width hd: r·S summed (2) and w S + k v (3) per (i, j); the bonus term
    factors as v_j · sum_i r_i u_i k_i, 3 per i and 2 per j."""
    return 5 * B * S * H * hd * (hd + 1)


def wkv_work(r, k, v, w, u, state=None) -> Work:
    """The WKV kernel: r, k, v, w, u read; y (f32) written; the (B, H, hd,
    hd) f32 state written, and read too when one is carried in."""
    B, S, H, hd = r.shape
    states = 2 if state is not None else 1
    return Work(nbytes(r, k, v, w, u) + 4 * B * S * H * hd
                + states * 4 * B * H * hd * hd, wkv_ops(B, S, H, hd))


def scan_ops(B: int, S: int, di: int, ds: int) -> Work:
    """The selective scan's state recurrence (no bytes): 6 operations and
    one exponential per (step, channel, state)."""
    return Work(0, 6 * B * S * di * ds, B * S * di * ds)


def scan_work(xc, delta, A, Bs, Cs, state=None) -> Work:
    """The selective scan: xc, Δ, A, B, C read; y (xc's type) written; the
    (B, di, ds) f32 state written, and read too when one is carried in.
    :func:`scan_ops` and one more operation per (step, channel)."""
    B, S, di = xc.shape
    ds = A.shape[1]
    states = 2 if state is not None else 1
    rec = scan_ops(B, S, di, ds)
    return Work(nbytes(xc, delta, A, Bs, Cs, xc) + states * 4 * B * di * ds,
                rec.ops + B * S * di, rec.exps)


# ---------------------------------------------------------------------------
# bounds and timers
# ---------------------------------------------------------------------------

def bytes_ms(nbytes_: float) -> float:
    """The least time to move ``nbytes_`` at the HBM rate, ms."""
    return nbytes_ / HBM_BW * 1e3


def ops_ms(ops: float, exps: float = 0, peak: float = PEAK_F32) -> float:
    """The least time for ``ops`` operations at ``peak`` and ``exps`` f32
    exponentials, the exponentials split between the special-function
    units and polynomials on the FMA pipes (POLY_EXP_OPS operations each)
    so that both finish together, ms."""
    return max(ops / peak, (ops + POLY_EXP_OPS * exps)
               / (peak + POLY_EXP_OPS * PEAK_SFU)) * 1e3


def bound_ms(work: Work, peak: float = PEAK_F32):
    """``(ms, "bytes" or "operations")``: the larger of the two least
    times of :class:`Work` ``work`` and which one it is."""
    by_bytes = bytes_ms(work.bytes)
    by_ops = ops_ms(work.ops, work.exps, peak)
    return max(by_bytes, by_ops), ("bytes" if by_bytes >= by_ops
                                   else "operations")


def median_ms(fn: Callable[[], object], reps: int) -> float:
    """Median ms of ``reps`` single calls of ``fn``, CUDA events around
    each, after one call to warm up."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def graph_ms(fn: Callable[[], object], n: int = 50, reps: int = 5) -> float:
    """Device time of one call of ``fn``: ``n`` calls captured in a CUDA
    graph, replayed between CUDA events (median of ``reps`` replays, over
    ``n``).  Unlike :func:`median_ms` it leaves out the host's time to
    launch, which a single short call cannot hide."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / n)
    del graph
    return float(np.median(times))
