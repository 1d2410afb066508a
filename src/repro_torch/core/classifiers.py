"""Hypothesis classes and the batched max-margin solver (counterpart of
``repro.core.classifiers``).

Thresholds (R^1), intervals (R^1) and axis-aligned rectangles (R^d) are the
JAX package's numpy classes, copied; each has ``fit`` (the 0-error learner
under the noiseless assumption), ``predict`` and ``error``.

The solver is hard-margin-annealed Pegasos, batched over B independent fit
sets: ``stages`` λ stages (λ0, λ0/10, …), each warm-started from the last,
the result latched at the first stage that reaches 0 training error and
canonicalised to functional margin 1.  It has the JAX package's two inner
loops: the classic d-unrolled loop in plain PyTorch, and the kernel path,
one :func:`repro_torch.kernels.pegasos_stage` launch per λ stage (the
hand-written CUDA kernel on the card, its plain version on the CPU).
``kernel=None`` takes the kernel path on a CUDA device and the classic loop
on the CPU, as the JAX package takes its Pallas kernel on a TPU only.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch import _device
from repro_torch.core.geometry import decide


# ---------------------------------------------------------------------------
# Thresholds (predict +1 iff x < t)  — paper Lemma 3.1
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Threshold:
    t: float

    def predict(self, X: np.ndarray) -> np.ndarray:
        x = np.asarray(X).reshape(-1)
        return np.where(x < self.t, 1, -1)

    def error(self, X: np.ndarray, y: np.ndarray) -> float:
        return float(np.mean(self.predict(X) != y)) if len(y) else 0.0

    @staticmethod
    def fit(X: np.ndarray, y: np.ndarray) -> "Threshold":
        """Any 0-error threshold on (X, y); assumes separability."""
        x = np.asarray(X).reshape(-1)
        pos = x[y == 1]
        neg = x[y == -1]
        lo = pos.max() if len(pos) else -np.inf  # t must exceed all positives
        hi = neg.min() if len(neg) else np.inf   # and be below all negatives
        if not lo < hi:
            raise ValueError("not separable by a threshold")
        if np.isinf(lo) and np.isinf(hi):
            t = 0.0
        elif np.isinf(lo):
            t = hi - 1.0
        elif np.isinf(hi):
            t = lo + 1.0
        else:
            t = 0.5 * (lo + hi)
        if not lo < t:
            # the midpoint of adjacent doubles, or lo + 1.0 once |lo| >=
            # 2**53, rounds to lo, which predict (x < t) labels -1; hi (or
            # the next double above lo) is a 0-error threshold instead
            t = hi if np.isfinite(hi) else np.nextafter(lo, np.inf)
        return Threshold(float(t))


# ---------------------------------------------------------------------------
# Intervals (predict +1 iff a <= x <= b) — paper Lemma 3.2
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Interval:
    a: float
    b: float

    def predict(self, X: np.ndarray) -> np.ndarray:
        x = np.asarray(X).reshape(-1)
        return np.where((x >= self.a) & (x <= self.b), 1, -1)

    def error(self, X: np.ndarray, y: np.ndarray) -> float:
        return float(np.mean(self.predict(X) != y)) if len(y) else 0.0

    @staticmethod
    def fit(X: np.ndarray, y: np.ndarray) -> "Interval":
        """Minimal enclosing interval of the positives (paper's choice: 'as
        small as possible'); assumes noiseless separability."""
        x = np.asarray(X).reshape(-1)
        pos = x[y == 1]
        if len(pos) == 0:
            return Interval(0.0, -1.0)  # empty interval
        a, b = float(pos.min()), float(pos.max())
        neg = x[y == -1]
        if len(neg) and np.any((neg >= a) & (neg <= b)):
            raise ValueError("not separable by an interval")
        return Interval(a, b)


# ---------------------------------------------------------------------------
# Axis-aligned rectangles in R^d — paper Theorem 3.2
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class AxisAlignedRectangle:
    lo: np.ndarray  # (d,)
    hi: np.ndarray  # (d,)
    positive_inside: bool = True

    def predict(self, X: np.ndarray) -> np.ndarray:
        X = np.atleast_2d(X)
        inside = np.all((X >= self.lo) & (X <= self.hi), axis=1)
        lab = np.where(inside, 1, -1)
        return lab if self.positive_inside else -lab

    def error(self, X: np.ndarray, y: np.ndarray) -> float:
        return float(np.mean(self.predict(X) != y)) if len(y) else 0.0

    @staticmethod
    def minimal(X: np.ndarray) -> Optional[Tuple[np.ndarray, np.ndarray]]:
        """Minimum enclosing rectangle (the 2d values A ships, Thm 3.2);
        None plays the paper's ∅ sentinel."""
        X = np.atleast_2d(X)
        if X.shape[0] == 0:
            return None
        return X.min(axis=0), X.max(axis=0)

    @staticmethod
    def merge(
        r1: Optional[Tuple[np.ndarray, np.ndarray]],
        r2: Optional[Tuple[np.ndarray, np.ndarray]],
    ) -> Optional[Tuple[np.ndarray, np.ndarray]]:
        """Coordinate-wise merge: R^+_{A∪B} from R^+_A and R^+_B."""
        if r1 is None:
            return r2
        if r2 is None:
            return r1
        return np.minimum(r1[0], r2[0]), np.maximum(r1[1], r2[1])

    @staticmethod
    def from_bounds(
        rect: Tuple[np.ndarray, np.ndarray], positive_inside: bool = True
    ) -> "AxisAlignedRectangle":
        return AxisAlignedRectangle(np.asarray(rect[0]), np.asarray(rect[1]), positive_inside)


# ---------------------------------------------------------------------------
# Linear separators — the batched max-margin solver
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class LinearSeparator:
    w: np.ndarray  # (d,)
    b: float
    margin: float = 0.0  # geometric margin on the fit set

    def predict(self, X: np.ndarray) -> np.ndarray:
        return np.where(np.atleast_2d(X) @ self.w + self.b > 0, 1, -1)

    def decision(self, X: np.ndarray) -> np.ndarray:
        return np.atleast_2d(X) @ self.w + self.b

    def error(self, X: np.ndarray, y: np.ndarray) -> float:
        return float(np.mean(self.predict(X) != y)) if len(y) else 0.0


# Warm-polish defaults: a quarter of a stage's step budget refines the
# carried separator, and the eta schedule starts as if WARM_OFFSET steps had
# already elapsed, so the first polish steps refine instead of kicking.
WARM_STEPS = 500
WARM_OFFSET = 1024.0


def lam_schedule(lam0: float, stages: int) -> Tuple[float, ...]:
    """The f32 λ of each stage, ``lam0 * 0.1 ** s`` rounded as the JAX
    package rounds it (f32 operands, one rounding per operation), computed
    on the host so the card and the CPU use the same values."""
    lam = torch.tensor(lam0, dtype=torch.float32)
    tenth = torch.tensor(0.1, dtype=torch.float32)
    return tuple(float(lam * tenth ** torch.tensor(float(s)))
                 for s in range(stages))


def _margins_min(X, y, valid, w, b) -> torch.Tensor:
    return torch.where(valid, y * decide(X, w, b), math.inf).amin(dim=1)


def _classic_stage(X, y, valid, nv, w, b, lam, nsteps, t0=0.0):
    """``nsteps`` Pegasos steps of the classic loop: the hinge gradient as d
    masked sums over the rows, as the JAX package unrolls it.  Square roots
    are correctly rounded (``kernels.pegasos.sqrt_rn``) on every device."""
    from repro_torch.kernels.pegasos import sqrt_rn

    d = X.shape[2]
    inv_sqrt_lam = 1.0 / sqrt_rn(lam)
    for i in range(nsteps):
        c = float(np.float32(i) + np.float32(2.0) + np.float32(t0))
        eta = 1.0 / (lam * c)
        m = y * decide(X, w, b)
        vy = ((m < 1.0) & valid).to(X.dtype) * y
        gsum = torch.stack([(vy * X[:, :, j]).sum(dim=1) for j in range(d)],
                           dim=1)
        gw = lam[:, None] * w - gsum / nv[:, None]
        gb = -vy.sum(dim=1) / nv
        w = w - eta[:, None] * gw
        b = b - eta * gb
        nrm = sqrt_rn((w * w).sum(dim=1))
        scale = torch.clamp(inv_sqrt_lam / (nrm + 1e-12), max=1.0)
        w, b = w * scale[:, None], b * scale
    return w, b


def _svm_solve(X: torch.Tensor, y: torch.Tensor, lam: float,
               steps: int = 2000) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pegasos projected subgradient on  λ/2 ||w||² + mean hinge(w·x+b),
    one instance: from zeros, ``steps`` steps of size ``1/(λ(i+2))``, the
    hinge gradient averaged over all n rows, each iterate projected onto
    the ball of radius ``1/sqrt(λ)`` (``+1e-12`` in the norm).

    It runs as one :func:`repro_torch.kernels.pegasos_stage` call at B=1
    (``nsteps=steps``, ``t0=0``, the latch outputs discarded): the CUDA
    kernel for tensors on the card, its plain version on the CPU.  The
    stage forms the same iteration as the JAX package's ``_svm_solve``
    with its sums in another order, so the two agree to float rounding,
    not bit for bit.  X (n, d) and y (n,) are taken in f32; returns
    ``(w, b)``, (d,) and () f32 on X's device.
    """
    from repro_torch.kernels.pegasos import pegasos_stage

    n, d = X.shape
    dev = X.device
    f32 = torch.float32
    X3 = X.to(f32).contiguous()[None]
    y2 = y.to(f32).contiguous()[None]
    zw = torch.zeros((1, d), dtype=f32, device=dev)
    zb = torch.zeros((1,), dtype=f32, device=dev)
    w, b, *_latch = pegasos_stage(
        X3, y2, torch.full((1,), float(n), dtype=f32, device=dev), zw, zb,
        torch.full((1,), lam, dtype=f32, device=dev),
        torch.zeros((1,), dtype=torch.bool, device=dev), zw, zb,
        nsteps=steps, t0=0.0)
    return w[0], b[0]


def _svm_solve_batch(
    X: torch.Tensor,               # (B, N, d) f32; label-0 rows are padding
    y: torch.Tensor,               # (B, N) f32 in {+1, -1, 0}
    lam0: float,                   # stage-0 λ
    steps: int = 2000,
    stages: int = 3,
    w0: Optional[torch.Tensor] = None,       # (B, d) warm-init separator
    b0: Optional[torch.Tensor] = None,       # (B,)
    warm_ok: Optional[torch.Tensor] = None,  # (B,) bool — init trustworthy
    warm_steps: int = WARM_STEPS,
    warm_offset: float = WARM_OFFSET,
    return_gate: bool = False,
    kernel: Optional[bool] = None,
    early_exit: Optional[bool] = None,
):
    """Batched hard-margin-annealed Pegasos: B independent fits in lock-step
    (the JAX package's ``_svm_solve_batch``).

    Label-0 rows are inert: no hinge violations, and the gradient
    normalises by each instance's valid row count.  Each stage warm-starts
    from the previous one; an instance latches at the first stage whose
    iterate classifies its fit set without error, and one that never does
    keeps the last stage's iterate.

    **Warm entry** (``w0``/``b0`` given): a polish of ``warm_steps`` steps
    at the stage-0 λ, with the step schedule offset by ``warm_offset``,
    refines the carried separator first.  It latches an instance whose
    carried separator already classified the fit set cleanly (and
    ``warm_ok``) and still does after the polish; the others fall through
    to the cold anneal from zeros.

    **Stage loop.**  The JAX package leaves its stage loop as soon as every
    instance has latched.  Here ``early_exit`` (default: on the CPU only,
    where reading ``found`` costs nothing) does the same; on the card every
    stage is launched, and the kernel path skips the steps of an instance
    that has latched (the classic loop steps it), whose later iterates the
    latch discards.  The results are the same either way.

    ``kernel`` picks the inner loop: ``True`` one
    :func:`repro_torch.kernels.pegasos_stage` per stage with the latch
    fused, ``False`` the classic loop, ``None`` the kernel path on a CUDA
    device.  The two are float approximations of the same optimum; their
    decisions agree, their floats need not.

    Returns ``(w, b, converged)`` canonicalised to functional margin 1
    at the support points, and with ``return_gate=True`` also the polish
    gate bits (the carried separator classified the fit set cleanly;
    all False on the cold entry).
    """
    from repro_torch.engine.dataplane import use_kernels_default
    from repro_torch.kernels.pegasos import pegasos_stage

    B, N, d = X.shape
    dev = X.device
    valid = y != 0
    nv = valid.sum(dim=1).clamp_min(1).to(X.dtype)
    use_kernel = use_kernels_default(dev) if kernel is None else bool(kernel)
    if early_exit is None:
        early_exit = dev.type == "cpu"
    lams = lam_schedule(lam0, max(stages, 1))

    def full(v):
        return torch.full((B,), v, dtype=X.dtype, device=dev)

    zeros_w = torch.zeros((B, d), dtype=X.dtype, device=dev)
    zeros_b = torch.zeros((B,), dtype=X.dtype, device=dev)
    no = torch.zeros((B,), dtype=torch.bool, device=dev)
    if w0 is not None:
        w0, b0 = w0.to(X.dtype), b0.to(X.dtype)
        ok0 = _margins_min(X, y, valid, w0, b0) > 0.0
        if warm_ok is not None:
            ok0 = ok0 & warm_ok
        gate = ok0
        if use_kernel:
            # polish runs un-latched (found=False in); the gate composes
            # the carried and the polished margin, as the classic loop
            w_p, b_p, mm_p, _f, _wb, _bb = pegasos_stage(
                X, y, nv, w0, b0, full(lams[0]), no, zeros_w, zeros_b,
                nsteps=warm_steps, t0=float(warm_offset))
            ok_p = ok0 & (mm_p > 0.0)
        else:
            w_p, b_p = _classic_stage(X, y, valid, nv, w0, b0,
                                      full(lams[0]), warm_steps,
                                      float(warm_offset))
            ok_p = ok0 & (_margins_min(X, y, valid, w_p, b_p) > 0.0)
        found = ok_p
        w_best = torch.where(ok_p[:, None], w_p, zeros_w)
        b_best = torch.where(ok_p, b_p, zeros_b)
    else:
        found, gate = no, no
        w_best, b_best = zeros_w, zeros_b

    w, b = zeros_w, zeros_b
    for s in range(stages):
        if early_exit and bool(found.all()):
            break
        if use_kernel:
            w, b, _mm, found, w_best, b_best = pegasos_stage(
                X, y, nv, w, b, full(lams[s]), found, w_best, b_best,
                nsteps=steps, skip_latched=True)
            continue
        w, b = _classic_stage(X, y, valid, nv, w, b, full(lams[s]), steps)
        ok = _margins_min(X, y, valid, w, b) > 0.0
        take = ok & ~found
        w_best = torch.where(take[:, None], w, w_best)
        b_best = torch.where(take, b, b_best)
        found = found | ok
    w = torch.where(found[:, None], w_best, w)
    b = torch.where(found, b_best, b)

    # canonicalise: functional margin 1 at the support points
    mmin = _margins_min(X, y, valid, w, b)
    can = found & torch.isfinite(mmin) & (mmin > 0.0)
    scale = torch.where(can, 1.0 / torch.where(can, mmin, 1.0), 1.0)
    if return_gate:
        return w * scale[:, None], b * scale, found, gate
    return w * scale[:, None], b * scale, found


def anneal_hard_margin(
    X: np.ndarray,
    y: np.ndarray,
    lam: float = 1e-3,
    steps: int = 2000,
    stages: int = 3,
    kernel: Optional[bool] = None,
    device="cuda",
) -> Tuple[np.ndarray, float, bool]:
    """Single-instance entry to the annealed solver (B=1) on ``device``:
    ``(w, b, converged)`` in float64/bool host types — the MAXMARG engine's
    per-turn fit at B=1."""
    dev = _device.resolve(device)
    Xt = torch.as_tensor(np.atleast_2d(X), dtype=torch.float32)[None].to(dev)
    yt = torch.as_tensor(np.asarray(y), dtype=torch.float32)[None].to(dev)
    w, b, ok = _svm_solve_batch(Xt, yt, lam, steps, stages, kernel=kernel)
    return (w[0].cpu().double().numpy(), float(b[0]), bool(ok[0]))


def fit_max_margin(
    X: np.ndarray,
    y: np.ndarray,
    steps: int = 2000,
    lam: float = 1e-3,
    refine: int = 2,
    device="cuda",
) -> LinearSeparator:
    """Approximate hard-margin SVM: the annealed solver at B=1 with
    ``refine + 1`` λ stages, canonicalised to min functional margin 1."""
    w, b, _ = anneal_hard_margin(X, y, lam=lam, steps=steps,
                                 stages=refine + 1, device=device)
    geo = (y * (X @ w + b)).min() / (np.linalg.norm(w) + 1e-30)
    return LinearSeparator(w, float(b), margin=float(geo))


def support_points(
    clf: LinearSeparator, X: np.ndarray, y: np.ndarray, rtol: float = 0.15,
    max_support: int = 8,
) -> np.ndarray:
    """Indices of active-margin points (functional margin within (1+rtol) of
    the minimum) — what MAXMARG ships each round.  Beyond ``max_support``
    the tightest are kept, exact margin ties by ascending index (the
    engine's (margin, index) order)."""
    m = y * (X @ clf.w + clf.b)
    mmin = max(m.min(), 1e-12)
    idx = np.where(m <= mmin * (1.0 + rtol))[0]
    if len(idx) > max_support:
        order = np.argsort(m[idx], kind="stable")
        idx = np.asarray(sorted(idx[order[:max_support]]))
    return idx
