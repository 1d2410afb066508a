"""The H100's figures and the work of the protocol kernels: a frozen copy
of ``repro_torch.analysis.bounds`` (the parts the protocol cells read), so
that a roofline share keeps its meaning whatever the program does.

Each work function returns :class:`Work` ``(bytes, ops, exps)`` for one
call from its inputs: each input read once, each output written once, and
the operations the call's data needs.  Tensors may be on the ``meta``
device where only their shapes matter.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

# NVIDIA H100 80GB HBM3, 700 W (data sheet, SXM, dense)
PEAK_F32 = 67e12              # FLOP/s outside the tensor cores
PEAK_FLOPS_BF16 = 989e12      # FLOP/s on the tensor cores
HBM_BW = 3.35e12              # bytes/s
# exponentials a second on the special-function units (16 a clock on each
# of 132 SMs at 1.98 GHz) and an f32 exponential as an FMA-pipe polynomial
PEAK_SFU = 132 * 16 * 1.98e9
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


def cut_work(V, dir_ok, lo, hi, X, y, live: Optional[int] = None) -> Work:
    """The cut scan: every input read once, the (B, m) int32 scores
    written; 2 multiplies and an add per live point (label not 0) and
    direction."""
    m = V.shape[0]
    live = _count(y != 0) if live is None else int(live)
    return Work(nbytes(V, dir_ok, lo, hi, X, y) + 4 * dir_ok.numel(),
                3 * live * m)


def extremes_work(v, X, y, wx=None, wy=None, width: int = 0) -> Work:
    """The extremes scan: v, the own rows and the transcripts' first
    ``width`` rows read; indices, flags, rows and edges written (34 bytes a
    node with a transcript, 8 without); 3 operations a live row."""
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
    """The turn scan: inputs read once, int32 sup_rank, err_k and
    viol_rank written; (2d + 2 + max_support) per valid fit-set row and
    (2d + 2 + viol_ship) per valid shard row."""
    B, N, d = K.shape
    k = y.shape[1]
    out = 4 * (B * N + B * k + y.numel())
    return Work(nbytes(w, b, K, yK, X, y) + out,
                (2 * d + 2 + max_support) * _count(yK != 0)
                + (2 * d + 2 + viol_ship) * _count(y != 0))


def pegasos_work(X, y, nv, w, b, lam, found, w_best, b_best, *,
                 nsteps: int) -> Work:
    """A Pegasos stage: inputs read once, (w, b, mmin, w_best, b_best) in
    f32 and found written; every valid row's margin (2d + 1) and hinge
    test at every step and in the final scan (the violating rows' gradient
    left out: a lower bound)."""
    B, _, d = X.shape
    out = 4 * (3 * B * d + 3 * B) + B
    return Work(nbytes(X, y, nv, w, b, lam, found, w_best, b_best) + out,
                (nsteps + 1) * _count(y != 0) * (2 * d + 2))


def bytes_ms(nbytes_: float) -> float:
    """The least time to move ``nbytes_`` at the HBM rate, ms."""
    return nbytes_ / HBM_BW * 1e3


def ops_ms(ops: float, exps: float = 0, peak: float = PEAK_F32) -> float:
    """The least time for ``ops`` operations at ``peak`` and ``exps`` f32
    exponentials shared between the special-function units and FMA-pipe
    polynomials so that both finish together, ms."""
    return max(ops / peak, (ops + POLY_EXP_OPS * exps)
               / (peak + POLY_EXP_OPS * PEAK_SFU)) * 1e3


def bound_ms(work: Work, peak: float = PEAK_F32):
    """``(ms, "bytes" or "operations")``: the larger of the two least
    times of ``work`` and which one it is."""
    by_bytes = bytes_ms(work.bytes)
    by_ops = ops_ms(work.ops, work.exps, peak)
    return max(by_bytes, by_ops), ("bytes" if by_bytes >= by_ops
                                   else "operations")
