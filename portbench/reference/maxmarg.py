"""Two-party MAXMARG (arXiv:1202.6078 §4.4, the per-round max-margin refit)
for a batch of independent instances, in plain PyTorch.

A turn of coordinator ``ci = turn % k``:

1. it fits a max-margin separator on its own points and the points it
   received: hard-margin-annealed Pegasos (λ0, then λ0/10, λ0/100, ``steps``
   each, the first stage whose iterate classifies the fit set without
   error is kept), polishing the previous proposal first where that one
   classifies the fit set cleanly;
2. the support points (margin within 15% of the least, at most
   ``max_support``, by (margin, row)) go to the others, in row order;
3. every node counts the proposal's errors on its points and sends an
   all-clear bit;
4. a node with errors ships its two most-violated points to the
   coordinator;
5. the protocol ends when all errors together are within the budget.

Only k = 2 is written out (the configuration's party count): there the
carried separator is the previous proposal.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

_I32 = torch.int32
RTOL = 0.15
VIOL_SHIP = 2
WARM_STEPS = 500
WARM_OFFSET = 1024.0


def _decide(X, w, b):
    """Σ_i x_i w_i left to right, then + b; X (b, ..., d), w (b, d)."""
    wb = w.reshape(w.shape[:1] + (1,) * (X.ndim - 2) + w.shape[1:])
    dec = X[..., 0] * wb[..., 0]
    for i in range(1, X.shape[-1]):
        dec = dec + X[..., i] * wb[..., i]
    return dec + b.reshape(b.shape + (1,) * (X.ndim - 2))


def _sqrt(x):
    """The correctly rounded square root (through float64)."""
    return torch.sqrt(x.double()).to(x.dtype)


def _min_margin(X, yf, valid, w, b):
    return torch.where(valid, yf * _decide(X, w, b),
                       torch.tensor(float("inf"), dtype=X.dtype,
                                    device=X.device)).amin(dim=1)


def _stage(X, yf, valid, nv, w, b, lam, nsteps, t0=0.0):
    """``nsteps`` projected subgradient steps on λ/2 |w|² + mean hinge, step
    size 1 / (λ (i + 2 + t0)), each iterate projected onto the ball of
    radius 1 / sqrt(λ).  ``lam`` is a 0-d host tensor in the fit's type;
    the step sizes are formed on the host in that type.  On a CUDA device
    the same steps are captured once into a CUDA graph per shape, type,
    λ, step count and offset, and replayed: the same kernels with the
    same arguments, without a launch from the host per operation."""
    if X.is_cuda:
        return _stage_graphed(X, yf, valid, nv, w, b, lam, nsteps, t0)
    return _steps(X, yf, valid, nv, w, b, lam, nsteps, t0)


_GRAPHS: Dict[tuple, tuple] = {}


def _stage_graphed(X, yf, valid, nv, w, b, lam, nsteps, t0):
    args = (X, yf, valid, nv, w, b)
    key = (tuple(tuple(a.shape) for a in args), X.dtype, X.device,
           float(lam), int(nsteps), float(t0))
    entry = _GRAPHS.get(key)
    if entry is None:
        static = [a.clone() for a in args]
        side = torch.cuda.Stream(device=X.device)
        side.wait_stream(torch.cuda.current_stream(X.device))
        with torch.cuda.stream(side):
            _steps(*static, lam, 2, t0)
        torch.cuda.current_stream(X.device).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = _steps(*static, lam, nsteps, t0)
        entry = _GRAPHS[key] = (graph, static, out)
    graph, static, out = entry
    for dst, src in zip(static, args):
        dst.copy_(src)
    graph.replay()
    return out[0].clone(), out[1].clone()


def _steps(X, yf, valid, nv, w, b, lam, nsteps, t0):
    inv_sqrt_lam = (1.0 / _sqrt(lam)).item()
    lam_f = lam.item()
    for i in range(nsteps):
        c = float(np.float32(i) + np.float32(2.0) + np.float32(t0))
        eta = (1.0 / (lam * c)).item()
        m = yf * _decide(X, w, b)
        vy = torch.where((m < 1.0) & valid, yf, 0.0)
        g = (vy[:, :, None] * X).sum(dim=1)
        w = w - eta * (lam_f * w - g / nv[:, None])
        b = b - eta * (-vy.sum(dim=1) / nv)
        nrm = _sqrt((w * w).sum(dim=1))
        scale = torch.clamp(inv_sqrt_lam / (nrm + 1e-12), max=1.0)
        w, b = w * scale[:, None], b * scale
    return w, b


def lam_schedule(lam0: float, stages: int, dtype):
    lam = torch.tensor(lam0, dtype=torch.float32)
    tenth = torch.tensor(0.1, dtype=torch.float32)
    return [(lam * tenth ** torch.tensor(float(s))).to(dtype)
            for s in range(stages)]


def solve(X, yi, lam0, steps, stages, w0, b0, warm_ok):
    """The annealed fit of each (b, N, d) fit set; ``w0``, ``b0`` the
    carried separators and ``warm_ok`` where one exists.  Returns (w, b,
    found) canonicalised to margin 1 at the support points."""
    B, N, d = X.shape
    dev, dt = X.device, X.dtype
    yf = yi.to(dt)
    valid = yi != 0
    nv = valid.sum(dim=1).clamp_min(1).to(dt)
    lams = lam_schedule(lam0, stages, dt)

    zw = torch.zeros((B, d), dtype=dt, device=dev)
    zb = torch.zeros((B,), dtype=dt, device=dev)
    ok0 = (_min_margin(X, yf, valid, w0, b0) > 0.0) & warm_ok
    found = torch.zeros(B, dtype=torch.bool, device=dev)
    w_best, b_best = zw, zb
    if bool(ok0.any()):
        w_p, b_p = _stage(X, yf, valid, nv, w0, b0, lams[0], WARM_STEPS,
                          WARM_OFFSET)
        found = ok0 & (_min_margin(X, yf, valid, w_p, b_p) > 0.0)
        w_best = torch.where(found[:, None], w_p, zw)
        b_best = torch.where(found, b_p, zb)
    w, b = zw, zb
    for s in range(stages):
        if bool(found.all()):
            break
        w, b = _stage(X, yf, valid, nv, w, b, lams[s], steps)
        ok = _min_margin(X, yf, valid, w, b) > 0.0
        take = ok & ~found
        w_best = torch.where(take[:, None], w, w_best)
        b_best = torch.where(take, b, b_best)
        found = found | ok
    w = torch.where(found[:, None], w_best, w)
    b = torch.where(found, b_best, b)
    mmin = _min_margin(X, yf, valid, w, b)
    can = found & torch.isfinite(mmin) & (mmin > 0.0)
    scale = torch.where(can, 1.0 / torch.where(can, mmin, 1.0), 1.0)
    return w * scale[:, None], b * scale, found


def _smallest(key, member, r):
    """Per row, the indices of the ``r`` smallest member entries by (key,
    index), -1 past the members; (b, r) long."""
    k2 = torch.where(member, key, torch.tensor(float("inf"), dtype=key.dtype,
                                               device=key.device))
    order = torch.argsort(k2, dim=1, stable=True)[:, :r]
    have = torch.gather(member, 1, order) & torch.isfinite(
        torch.gather(k2, 1, order))
    return torch.where(have, order, -1)


def run(X, y, budget, *, max_epochs: int, max_support: int, steps: int,
        stages: int, lam: float, dtype=torch.float32) -> Dict[str, torch.Tensor]:
    """MAXMARG over b instances at k = 2: ``X`` (b, k, n, d) in ``dtype``,
    ``y`` (b, k, n) int32 ±1 (0 = padding), ``budget`` (b,).  Returns per
    instance ``converged``, ``epochs``, the separator ``h_w``, ``h_b``
    (predict +1 iff w·x + b > 0) and the counters ``points``, ``scalars``,
    ``bits``, ``messages``, ``rounds``."""
    bsz, k, n, d = X.shape
    if k != 2:
        raise ValueError(f"the MAXMARG reference is written for k = 2, "
                         f"got k = {k}")
    dev = X.device
    cap = max_epochs * (max_support + 2) * (k - 1) + 8
    wx = torch.zeros((bsz, k, cap, d), dtype=dtype, device=dev)
    wy = torch.zeros((bsz, k, cap), dtype=_I32, device=dev)
    fill = torch.zeros((bsz, k), dtype=torch.long, device=dev)
    done = torch.zeros(bsz, dtype=torch.bool, device=dev)
    converged = torch.zeros_like(done)
    epochs = torch.zeros(bsz, dtype=_I32, device=dev)
    h_w = torch.zeros((bsz, d), dtype=dtype, device=dev)
    h_b = torch.zeros(bsz, dtype=dtype, device=dev)
    h_valid = torch.zeros_like(done)
    cnt = {c: torch.zeros(bsz, dtype=torch.long, device=dev)
           for c in ("points", "scalars", "bits", "messages", "rounds")}
    rows = torch.arange(bsz, device=dev)
    valid_all = y != 0

    def append(j, pts, labs):
        for r in range(labs.shape[1]):
            sel = torch.nonzero(labs[:, r] != 0).flatten()
            at = fill[sel, j]
            if sel.numel() and int(at.max()) >= cap:
                raise RuntimeError("reference transcript overflow")
            wx[sel, j, at] = pts[sel, r]
            wy[sel, j, at] = labs[sel, r]
            fill[sel, j] += 1

    for turn in range(k * max_epochs):
        if bool(done.all()):
            break
        active = ~done
        act = active.long()
        ci = turn % k
        # 1. the coordinator's refit on own points and received ones
        K = torch.cat([X[:, ci], wx[:, ci]], dim=1)
        yK = torch.cat([y[:, ci], wy[:, ci]], dim=1)
        w, b, _found = solve(K, yK, lam, steps, stages, h_w, h_b, h_valid)
        # 2. support points, shipped in row order
        yKf = yK.to(dtype)
        mK = yKf * _decide(K, w, b)
        validK = yK != 0
        mmin = torch.where(validK, mK, torch.tensor(
            float("inf"), dtype=dtype, device=dev)).amin(dim=1)
        mmin = mmin.clamp_min(1e-12)
        band = validK & (mK <= (mmin * torch.tensor(1.0 + RTOL,
                                                    dtype=dtype))[:, None])
        pick = _smallest(mK, band, max_support)                 # (b, r)
        ordered = torch.sort(torch.where(pick >= 0, pick, K.shape[1]),
                             dim=1).values
        nsel = (pick >= 0).sum(dim=1)
        safe = ordered.clamp(max=K.shape[1] - 1)
        S_pts = K[rows[:, None], safe]
        S_lab = torch.where(torch.arange(max_support, device=dev)[None, :]
                            < nsel[:, None], yK[rows[:, None], safe], 0)
        S_lab = torch.where(active[:, None], S_lab, 0).to(_I32)
        cnt["points"] += act * nsel * (k - 1)
        cnt["messages"] += act * (k - 1)
        cnt["rounds"] += act
        for j in range(k):
            if j != ci:
                append(j, S_pts, S_lab)
        # 3. every node's errors and all-clear bits
        dec = _decide(X, w, b)                                   # (b, k, n)
        pred = torch.where(dec > 0, 1, -1)
        err_k = ((pred != y) & valid_all).sum(dim=2)             # (b, k)
        errs = err_k.sum(dim=1)
        cnt["bits"] += act * (k - 1)
        cnt["messages"] += act * (k - 1)
        # 4. violated nodes ship their two most-violated points
        n_valid = valid_all.sum(dim=2)
        for i in range(k):
            if i == ci:
                continue
            fire = active & (err_k[:, i] > 0)
            nv = torch.clamp(n_valid[:, i], max=VIOL_SHIP)
            cnt["points"] += torch.where(fire, nv, 0)
            cnt["messages"] += fire.long()
            worst = _smallest(y[:, i].to(dtype) * dec[:, i], valid_all[:, i],
                              VIOL_SHIP)
            safe_v = worst.clamp(min=0)
            V_pts = X[rows[:, None], i, safe_v]
            V_lab = torch.where((worst >= 0) & fire[:, None],
                                y[rows[:, None], i, safe_v], 0).to(_I32)
            append(ci, V_pts, V_lab)
        # 5. termination and the carried proposal
        term = active & (errs <= budget)
        epochs = torch.where(term, turn // k + 1, epochs)
        done = done | term
        converged = converged | term
        h_w = torch.where(active[:, None], w, h_w)
        h_b = torch.where(active, b, h_b)
        h_valid = h_valid | active
    return dict(converged=converged, epochs=epochs, h_w=h_w, h_b=h_b, **cnt)
