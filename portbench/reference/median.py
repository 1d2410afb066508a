"""MEDIAN / k-party (arXiv:1202.6078 §5 and §6.2, the certified-pivot
epoch protocol) for a batch of independent instances, in plain PyTorch.

Each instance keeps a grid of m unit directions, per node a transcript of
the points it has seen and, per direction, the consistent-threshold range
(lo, hi) of that transcript.  A turn of coordinator ``ci = turn % k``:

1. scores every allowed direction by its weighted median cut over the
   coordinator's own points (the smaller of the counts of points whose
   whole at-risk arc lies on either side) and picks the first best;
2. broadcasts its extreme band points S along v and the scalars (v, lo,
   hi); S lands in every transcript;
3. ends early when the band midpoint misclassifies at most the budget;
4. every node finds its extreme band points along v over its points and
   transcript, and the others reply with theirs;
5. a non-empty global band ends the protocol at its midpoint; an empty
   one broadcasts the violating pair and prunes the directions it rules
   out.

Projections are ``(v0 * x0) + (v1 * x1)`` with one rounding per
operation; all arithmetic is in ``dtype``.  Every transcript is read at
its full capacity.  Communication is metered as points, scalars, bits,
messages and rounds.
"""

from __future__ import annotations

import math
from typing import Dict

import torch

_INF = math.inf
_I32 = torch.int32


def direction_grid(m: int, dtype, device) -> torch.Tensor:
    """(m, 2) unit vectors at the angles of the f32 ``linspace(0, 2π, m,
    endpoint=False)``, cos and sin taken in float64 and rounded once."""
    theta = torch.linspace(0.0, 2.0 * math.pi, m + 1,
                           dtype=torch.float32)[:-1].double()
    V = torch.stack([torch.cos(theta), torch.sin(theta)], dim=-1)
    return V.to(dtype).to(device)


def _dot(X, v):
    """x0 * v0 + x1 * v1 over the last axis, v broadcast against X."""
    return X[..., 0] * v[..., 0] + X[..., 1] * v[..., 1]


def cut_scores(V, dir_ok, lo, hi, X, y, chunk: int = 1 << 25):
    """(b, m) int32 scores, -1 at disallowed directions.  A point is at
    risk at a direction whose range is non-empty and allowed when its
    projection passes the range's bound on its own side; a point with no
    risk anywhere is not counted."""
    b, m = dir_ok.shape
    n = X.shape[1]
    per = max(1, chunk // max(1, m * n))
    out = []
    idx = torch.arange(m, device=X.device)
    for s in range(0, b, per):
        sl = slice(s, s + per)
        Xs, ys = X[sl], y[sl]
        proj = (Xs[:, None, :, 0] * V[None, :, None, 0]
                + Xs[:, None, :, 1] * V[None, :, None, 1])   # (c, m, n)
        open_ = (lo[sl] < hi[sl]) & dir_ok[sl]
        lo_r = torch.where(open_, lo[sl], _INF)[:, :, None]
        hi_r = torch.where(open_, hi[sl], -_INF)[:, :, None]
        pos = (ys == 1)[:, None, :]
        risk = torch.where(pos, proj > lo_r, proj < hi_r)
        del proj
        last = torch.where(risk, idx[None, :, None], -1).amax(dim=1)
        first = torch.where(risk, idx[None, :, None], m).amin(dim=1)
        del risk
        counted = (ys != 0) & (last >= 0)                       # (c, n)
        below = ((last[:, None, :] <= idx[None, :, None])
                 & counted[:, None, :]).sum(dim=2)
        above = ((first[:, None, :] > idx[None, :, None])
                 & counted[:, None, :]).sum(dim=2)
        out.append(torch.where(dir_ok[sl], torch.minimum(below, above),
                               -1).to(_I32))
    return torch.cat(out)


class _Transcripts:
    """Per node: received points (label 0 = empty), fill, and the running
    consistent-threshold range per direction."""

    def __init__(self, b, k, cap, m, dtype, device):
        self.x = torch.zeros((b, k, cap, 2), dtype=dtype, device=device)
        self.y = torch.zeros((b, k, cap), dtype=_I32, device=device)
        self.fill = torch.zeros((b, k), dtype=torch.long, device=device)
        self.lo = torch.full((b, k, m), -_INF, dtype=dtype, device=device)
        self.hi = torch.full((b, k, m), _INF, dtype=dtype, device=device)

    def append(self, j, V, pts, labs, do):
        """Append the ≤ 2 rows ``pts`` (b, 2, 2) with labels ``labs`` (b, 2)
        (valid rows first, 0 = none) to node j where ``do``."""
        labs = torch.where(do[:, None], labs, 0).to(_I32)
        pv = (pts[:, None, :, 0] * V[None, :, None, 0]
              + pts[:, None, :, 1] * V[None, :, None, 1])       # (b, m, 2)
        self.lo[:, j] = torch.maximum(self.lo[:, j], torch.where(
            (labs == 1)[:, None, :], pv, -_INF).amax(dim=2))
        self.hi[:, j] = torch.minimum(self.hi[:, j], torch.where(
            (labs == -1)[:, None, :], pv, _INF).amin(dim=2))
        for r in range(2):
            take = labs[:, r] != 0
            rows = torch.nonzero(take).flatten()
            at = self.fill[rows, j]
            if rows.numel() and int(at.max()) >= self.x.shape[2]:
                raise RuntimeError("reference transcript overflow")
            self.x[rows, j, at] = pts[rows, r]
            self.y[rows, j, at] = labs[rows, r]
            self.fill[rows, j] += 1


def _block(has_p, has_q, p, q):
    """The ≤ 2-row block of a node's extremes: the positive extreme first
    when there is one."""
    pts = torch.stack([torch.where(has_p[:, None], p, q), q], dim=1)
    labs = torch.stack([torch.where(has_p, 1, torch.where(has_q, -1, 0)),
                        torch.where(has_p & has_q, -1, 0)], dim=1)
    return pts, labs.to(_I32)


def _extremes(XW, yW, v):
    """Along v: the first highest +1 row and first lowest -1 row of each
    (b, ·) set, whether each class is present, and their projections."""
    pj = _dot(XW, v[:, None, :])
    pos, neg = yW == 1, yW == -1
    has_p, has_q = pos.any(dim=1), neg.any(dim=1)
    ip = torch.where(pos, pj, -_INF).argmax(dim=1)
    iq = torch.where(neg, pj, _INF).argmin(dim=1)
    rows = torch.arange(XW.shape[0], device=XW.device)
    p, q = XW[rows, ip], XW[rows, iq]
    lo = torch.where(has_p, pj[rows, ip], -_INF)
    hi = torch.where(has_q, pj[rows, iq], _INF)
    return has_p, has_q, p, q, lo, hi


def run(X, y, budget, *, n_angles: int, max_epochs: int,
        dtype=torch.float32) -> Dict[str, torch.Tensor]:
    """MEDIAN over b instances: ``X`` (b, k, n, 2) in ``dtype``, ``y`` (b,
    k, n) int32 ±1 (0 = padding), ``budget`` (b,) the misclassifications
    allowed.  Returns per instance ``converged``, ``epochs``, the
    separator's direction ``h_v`` and threshold ``h_t`` (predict +1 iff
    v·x < t) and the counters ``points``, ``scalars``, ``bits``,
    ``messages``, ``rounds``."""
    b, k, n, _ = X.shape
    dev = X.device
    m = n_angles
    V = direction_grid(m, dtype, dev)
    cap = k * max_epochs * (2 * k + 2) + 8
    T = _Transcripts(b, k, cap, m, dtype, dev)
    rows = torch.arange(b, device=dev)
    dir_ok = torch.ones((b, m), dtype=torch.bool, device=dev)
    done = torch.zeros(b, dtype=torch.bool, device=dev)
    converged = torch.zeros_like(done)
    epochs = torch.zeros(b, dtype=_I32, device=dev)
    h_v = torch.zeros((b, 2), dtype=dtype, device=dev)
    h_t = torch.zeros(b, dtype=dtype, device=dev)
    h_valid = torch.zeros_like(done)
    cnt = {c: torch.zeros(b, dtype=torch.long, device=dev)
           for c in ("points", "scalars", "bits", "messages", "rounds")}
    km1 = k - 1
    for turn in range(k * max_epochs):
        if bool(done.all()):
            break
        active = ~done
        act = active.long()
        ci = turn % k
        # 1-2. the coordinator's weighted-median direction
        score = cut_scores(V, dir_ok, T.lo[:, ci], T.hi[:, ci], X[:, ci],
                           y[:, ci])
        v_idx = score.argmax(dim=1)
        v = V[v_idx]
        # 3. its band over own points and transcript, S broadcast
        XWc = torch.cat([X[:, ci], T.x[:, ci]], dim=1)
        yWc = torch.cat([y[:, ci], T.y[:, ci]], dim=1)
        has_p, has_q, p_pt, q_pt, lo_c, hi_c = _extremes(XWc, yWc, v)
        nS = has_p.long() + has_q.long()
        cnt["points"] += act * nS * km1
        cnt["scalars"] += act * 4 * km1
        cnt["messages"] += act * 2 * km1
        cnt["rounds"] += act
        S_pts, S_lab = _block(has_p, has_q, p_pt, q_pt)
        for j in range(k):
            T.append(j, V, S_pts, S_lab, active)
        # 4. early exit on the band midpoint
        band_c = (torch.isfinite(lo_c) & torch.isfinite(hi_c)
                  & (lo_c < hi_c))
        t_c = 0.5 * (lo_c + hi_c)
        pja = _dot(X, v[:, None, None, :])
        pred = torch.where(pja < t_c[:, None, None], 1, -1)
        errs = ((pred != y) & (y != 0)).sum(dim=(1, 2))
        term_eps = active & band_c & (errs <= budget)
        fire_err = (active & band_c).long()
        cnt["scalars"] += fire_err * km1
        cnt["messages"] += fire_err * km1
        # 5. every node's extremes over own points and transcript
        ext = [_extremes(torch.cat([X[:, i], T.x[:, i]], dim=1),
                         torch.cat([y[:, i], T.y[:, i]], dim=1), v)
               for i in range(k)]
        lo_k = torch.stack([e[4] for e in ext], dim=1)
        hi_k = torch.stack([e[5] for e in ext], dim=1)
        p_k = torch.stack([e[2] for e in ext], dim=1)
        q_k = torch.stack([e[3] for e in ext], dim=1)
        lo_g, hi_g = lo_k.amax(dim=1), hi_k.amin(dim=1)
        best_p = p_k[rows, lo_k.argmax(dim=1)]
        best_q = q_k[rows, hi_k.argmin(dim=1)]
        live = active & ~term_eps
        for i in range(k):
            n_i = ext[i][0].long() + ext[i][1].long()
            reply = (live & (n_i > 0)).long() if i != ci else 0 * n_i
            cnt["points"] += reply * n_i
            cnt["messages"] += reply
        for i in range(k):
            E_pts, E_lab = _block(ext[i][0], ext[i][1], ext[i][2], ext[i][3])
            src = live if i != ci else torch.zeros_like(live)
            for j in range(k):
                if j == ci or j == i:
                    T.append(j, V, E_pts, E_lab, src)
        # 6. global band: end at its midpoint; else the certified pivot
        band_g = lo_g < hi_g
        lo_g2 = torch.where(torch.isfinite(lo_g), lo_g, hi_g - 2.0)
        hi_g2 = torch.where(torch.isfinite(hi_g), hi_g, lo_g2 + 2.0)
        t_star = 0.5 * (lo_g2 + hi_g2)
        fire_band = live & band_g
        cnt["bits"] += fire_band.long() * km1
        cnt["messages"] += fire_band.long() * km1
        fire_pivot = live & ~band_g
        diff = best_q - best_p
        constraint = (V[None, :, 0] * diff[:, None, 0]
                      + V[None, :, 1] * diff[:, None, 1])
        new_ok = (dir_ok & (constraint > 1e-12)
                  & (torch.arange(m, device=dev)[None, :] != v_idx[:, None]))
        prune = (fire_pivot & new_ok.any(dim=1))[:, None]
        dir_ok = torch.where(prune, new_ok, dir_ok)
        cnt["points"] += fire_pivot.long() * 2 * km1
        cnt["messages"] += fire_pivot.long() * km1
        P_pts = torch.stack([best_p, best_q], dim=1)
        P_lab = (fire_pivot[:, None].to(_I32)
                 * torch.tensor([1, -1], dtype=_I32, device=dev)[None, :])
        for j in range(k):
            T.append(j, V, P_pts, P_lab, fire_pivot)
        # the hypothesis: band > early-exit candidate > fallback
        set_cand = active & band_c
        t_fb = torch.where(torch.isfinite(lo_c) & torch.isfinite(hi_c),
                           t_c, 0.0)
        set_fb = fire_pivot & ~h_valid & ~set_cand
        any_set = set_cand | fire_band | set_fb
        h_v = torch.where(any_set[:, None], v, h_v)
        h_t = torch.where(fire_band, t_star, torch.where(
            set_cand, t_c, torch.where(set_fb, t_fb, h_t)))
        h_valid = h_valid | any_set
        newly = term_eps | fire_band
        epochs = torch.where(newly, turn // k + 1, epochs)
        done = done | newly
        converged = converged | newly
    return dict(converged=converged, epochs=epochs, h_v=h_v, h_t=h_t, **cnt)
