"""Two-way two-party ITERATIVESUPPORTS (paper §4–5); counterpart of
``repro.core.protocols.two_way``.

* **MAXMARG** (§4.4) and **MEDIAN** (the certified-pivot protocol in R^2)
  are the k=2 instances of the k-party epoch protocols, run on the batched
  engine with B=1.
* **MEDIAN with rotation bits** (:func:`iterative_support_median_bit`, §5's
  basic protocol, kept for comparison) and the **noisy** MAXMARG of §8.2
  (:func:`iterative_support_noisy`) are host loops over the nodes of
  :func:`repro_torch.core.comm.make_nodes`, as in the JAX package: the
  control flow is numpy, while the bulk work runs on ``device`` — the
  consistent-threshold range scans and the (m, n) risk matrix of the bit
  protocol (the ranges kernel at B=1 on the card), and the noisy
  protocol's soft-margin fits (one Pegasos stage kernel at B=1 a fit).

The direction continuum S¹ is discretized to ``n_angles`` unit vectors
(:func:`repro_torch.core.geometry.direction_grid`).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from repro_torch import _device
from repro_torch.core import classifiers as clf
from repro_torch.core import geometry as geo
from repro_torch.core.comm import Node, make_nodes
from repro_torch.core.protocols.one_way import ProtocolResult


# ---------------------------------------------------------------------------
# shared helpers
# ---------------------------------------------------------------------------

def _global_error(h, nodes) -> float:
    n_err = sum(int(h.error(nd.X, nd.y) * nd.n) for nd in nodes)
    n_tot = sum(nd.n for nd in nodes)
    return n_err / n_tot


def _fit_known(node: Node, device="cuda") -> clf.LinearSeparator:
    X, y = node.all_known()
    return clf.fit_max_margin(X, y, device=device)


# ---------------------------------------------------------------------------
# MAXMARG
# ---------------------------------------------------------------------------

def iterative_support_maxmarg(
    shards,
    eps: float = 0.05,
    max_rounds: int = 64,
    max_support: int = 4,
    device="cuda",
) -> ProtocolResult:
    """Paper §4.4 MAXMARG for two parties: each turn one party refits
    max-margin on everything it knows and ships its active-margin support
    points; the peer answers with an all-clear bit or its most-violated
    points.  ``max_rounds`` counts turns and maps to ``max_rounds // 2``
    two-turn epochs (at least 1); the result's ``rounds`` counts epochs,
    ``comm["rounds"]`` turns."""
    from repro_torch.core.protocols.kparty import iterative_support_kparty
    return iterative_support_kparty(shards[:2], eps=eps,
                                    max_epochs=max(1, max_rounds // 2),
                                    selector="maxmarg",
                                    max_support=max_support, device=device)


# ---------------------------------------------------------------------------
# MEDIAN
# ---------------------------------------------------------------------------

def _transcript(node: Node, sent_X, sent_y):
    X = np.concatenate([node.recv_X] + ([np.stack(sent_X)] if sent_X else []))
    y = np.concatenate([node.recv_y] + ([np.asarray(sent_y, dtype=np.int32)] if sent_y else []))
    if X.size == 0:
        X = np.zeros((0, node.d))
        y = np.zeros((0,), dtype=np.int32)
    return X, y


def _on(a, dev, dtype=None) -> torch.Tensor:
    """A host array as a tensor on ``dev`` (copied: host arrays may be
    read-only)."""
    return torch.tensor(np.asarray(a), dtype=dtype, device=dev)


def _sou(node: Node, V, dir_ok, Wx, Wy, device="cuda") -> np.ndarray:
    """Boolean SOU mask over node's own points
    (:func:`repro_torch.core.geometry.uncertain_mask` on ``device``)."""
    if Wx.shape[0] == 0:
        return np.ones(node.n, dtype=bool)
    dev = _device.resolve(device)
    mask = geo.uncertain_mask(
        _on(V, dev), _on(dir_ok, dev), _on(Wx, dev), _on(Wy, dev),
        _on(node.X, dev), _on(node.y, dev))
    return mask.cpu().numpy()


def _risk_matrix(node: Node, V, dir_ok, Wx, Wy, device="cuda") -> np.ndarray:
    """(m_angles, n_points) at-risk booleans for median splitting.

    The ranges are the f32 scan of the transcript; the node's projections
    are float64, as the JAX package forms ``V @ X.T`` on the host (f32
    directions, float64 points); both run on ``device``."""
    if Wx.shape[0] == 0:
        return np.ones((V.shape[0], node.n), dtype=bool) & dir_ok[:, None]
    dev = _device.resolve(device)
    Vd = _on(V, dev)
    lo, hi = geo.consistent_threshold_ranges(Vd, _on(Wx, dev), _on(Wy, dev))
    nonempty = (lo < hi) & _on(dir_ok, dev)
    proj = geo.project(Vd.double(), _on(node.X, dev, torch.float64))  # (m, n)
    pos = _on(node.y == 1, dev)
    risk = torch.where(pos[None, :], proj > lo.double()[:, None],
                       proj < hi.double()[:, None])
    return (risk & nonempty[:, None]).cpu().numpy()


def _pick_median_direction(risk: np.ndarray, dir_ok: np.ndarray) -> int:
    """Pick the allowed direction index that best halves the at-risk mass.

    Discretized analogue of Alg. 2's weighted-median hull edge: for every
    candidate cut angle θ, count the points whose entire risk arc lies
    (strictly) on each side; choose θ maximizing the smaller count, so that
    whichever side the receiver's bit discards, ≥ that many points leave the
    SOU.
    """
    idxs = np.where(dir_ok)[0]
    if len(idxs) <= 1:
        return int(idxs[0]) if len(idxs) else 0
    sub = risk[idxs]  # (m_ok, n) — ordered along the allowed arc
    csum = np.cumsum(sub, axis=0)
    total = csum[-1]
    active = total > 0
    # point's arc entirely below cut i  <=>  csum[i] == total (no risk above);
    # entirely above  <=>  csum[i] == 0.  Full scan over every allowed cut.
    below = np.sum((csum == total[None, :]) & active[None, :], axis=1)
    above = np.sum((csum == 0) & active[None, :], axis=1)
    score = np.minimum(below, above)
    return int(idxs[int(np.argmax(score))])


def _support_along(node: Node, v: np.ndarray, Wx, Wy):
    """Support points of the max-margin 0-error classifier along fixed
    direction v on (own ∪ transcript): the extreme positive and negative
    projections (the band edges) — the constant-size S of paper §5.1(1).

    A missing class (single-class shard, the paper's ∅ case) contributes no
    point and an infinite band edge — it must NOT contribute a mislabeled
    stand-in, or the shared transcript is poisoned."""
    X = np.concatenate([node.X, Wx]); y = np.concatenate([node.y, Wy])
    proj = X @ v
    pos = y == 1
    pts, labs = [], []
    lo, hi = -np.inf, np.inf
    # predict +1 iff v·x < t  =>  band is (max_+ proj, min_- proj)
    if pos.any():
        i_pos = int(np.argmax(np.where(pos, proj, -np.inf)))
        lo = float(proj[i_pos])
        pts.append(X[i_pos]); labs.append(1)
    if (~pos).any():
        i_neg = int(np.argmin(np.where(~pos, proj, np.inf)))
        hi = float(proj[i_neg])
        pts.append(X[i_neg]); labs.append(-1)
    S_X = np.stack(pts) if pts else np.zeros((0, X.shape[1]))
    return S_X, np.asarray(labs, dtype=np.int32), lo, hi


def _best_threshold(node: Node, v: np.ndarray, lo: float, hi: float, Wx, Wy) -> Tuple[float, int]:
    """Receiver's early-termination scan (§4.3): best consistent threshold
    t ∈ (lo', hi') along v, where (lo', hi') also respects the receiver's
    transcript; returns (t, #errors on own shard)."""
    if Wx.shape[0]:
        projW = Wx @ v
        lo = max(lo, float(np.max(np.where(Wy == 1, projW, -np.inf))))
        hi = min(hi, float(np.min(np.where(Wy == -1, projW, np.inf))))
    if not lo < hi:
        return 0.5 * (lo + hi), 10 ** 9
    proj = node.X @ v
    cand = np.unique(np.clip(np.concatenate([proj, [lo + 1e-12, hi - 1e-12]]), lo + 1e-12, hi - 1e-12))
    pred = proj[None, :] < cand[:, None]  # predict +1
    errs = np.sum(pred != (node.y == 1)[None, :], axis=1)
    i = int(np.argmin(errs))
    return float(cand[i]), int(errs[i])


def iterative_support_median(
    shards,
    eps: float = 0.05,
    max_rounds: int = 64,
    n_angles: int = 1024,
    device="cuda",
) -> ProtocolResult:
    """Paper §5 protocol with the certified-pivot reply (DESIGN.md): the
    receiver replies with its extreme band points — the paper's §5.2
    pivoting rule — which never discards a consistent direction."""
    from repro_torch.core.protocols.kparty import iterative_support_kparty
    return iterative_support_kparty(shards[:2], eps=eps,
                                    max_epochs=max_rounds // 2,
                                    n_angles=n_angles, selector="median",
                                    device=device)


def iterative_support_median_bit(
    shards,
    eps: float = 0.05,
    max_rounds: int = 64,
    n_angles: int = 1024,
    device="cuda",
) -> ProtocolResult:
    """Paper §5 basic protocol, literal rotation-bit replies (kept for
    comparison; see :func:`iterative_support_median` for why it is not the
    default), symmetric extension (§5.3), discretized S¹.

    Each round the sender's risk matrix and the receiver's separability
    scan run on ``device`` (two B=1 ranges scans: the sender's transcript
    and the receiver's own ∪ transcript); the rest is the JAX package's
    numpy loop."""
    dev = _device.resolve(device)
    nodes, log = make_nodes(shards[:2])
    A, B = nodes
    if A.d != 2:
        raise ValueError("MEDIAN is specified for R^2 (paper §8.2)")
    n_total = A.n + B.n
    budget = int(np.floor(eps * n_total))
    Vd = geo.direction_grid(n_angles, device=dev)
    V = Vd.cpu().numpy()
    dir_ok = {A.name: np.ones(n_angles, dtype=bool), B.name: np.ones(n_angles, dtype=bool)}
    sent: dict = {A.name: ([], []), B.name: ([], [])}

    h = None
    for rnd in range(max_rounds):
        log.new_round()
        src, dst = (A, B) if rnd % 2 == 0 else (B, A)

        # --- src picks its median direction over its SOU -------------------
        Wx_s, Wy_s = _transcript(src, *sent[src.name])
        risk = _risk_matrix(src, V, dir_ok[src.name], Wx_s, Wy_s, device=dev)
        v_idx = _pick_median_direction(risk, dir_ok[src.name])
        v = V[v_idx]
        S_X, S_y, lo, hi = _support_along(src, v, Wx_s, Wy_s)
        src.send_points(dst, S_X, S_y, tag="median-support")
        sent[src.name][0].extend(list(S_X)); sent[src.name][1].extend(list(S_y))
        src.send_scalars(dst, np.concatenate([v, [lo, hi]]), tag="median-direction")

        # --- dst: early termination or rotation bit ------------------------
        Wx_d, Wy_d = _transcript(dst, *sent[dst.name])
        t, err_dst = _best_threshold(dst, v, lo, hi, Wx_d, Wy_d)
        cand = clf.LinearSeparator(-v, t)  # predict +1 iff v·x < t
        err_src = int(cand.error(src.X, src.y) * src.n)
        if err_dst + err_src <= budget:
            dst.send_bit(src, 0, tag="terminate")
            dst.send_scalars(src, np.asarray([t]), tag="final-threshold")
            return ProtocolResult(cand, log.summary(), rounds=rnd + 1, converged=True)

        # rotation bit: which side of v do dst's consistent directions lie on?
        Xd = np.concatenate([dst.X, Wx_d]); yd = np.concatenate([dst.y, Wy_d])
        lo_d, hi_d = geo.consistent_threshold_ranges(Vd, _on(Xd, dev), _on(yd, dev))
        sep = (lo_d < hi_d).cpu().numpy() & dir_ok[dst.name]
        order = np.where(dir_ok[src.name])[0]
        pos_in_arc = np.searchsorted(order, v_idx)
        sep_arc = sep[order]
        left_ok = bool(np.any(sep_arc[:pos_in_arc]))
        bit = +1 if left_ok else -1
        dst.send_bit(src, 1 if bit == 1 else 0, tag="rotate")

        # --- src (and dst, symmetrically) shrink their intervals -----------
        for name in (src.name, dst.name):
            ok = dir_ok[name]
            arc = np.where(ok)[0]
            cut = np.searchsorted(arc, v_idx)
            keep = arc[:cut] if bit == +1 else arc[cut + 1:]
            new_ok = np.zeros_like(ok)
            new_ok[keep] = True
            if new_ok.any():
                dir_ok[name] = new_ok

        h = cand
    return ProtocolResult(h, log.summary(), rounds=max_rounds, converged=False)


# ---------------------------------------------------------------------------
# Noisy setting (paper §8.2 outline, implemented)
# ---------------------------------------------------------------------------

def iterative_support_noisy(
    shards,
    eps: float = 0.05,
    noise_margin: float = 0.1,
    max_rounds: int = 64,
    max_support: int = 6,
    device="cuda",
) -> ProtocolResult:
    """MAXMARG adapted to noisy data per the paper's §8.2 heuristic: players
    never propose 0-error classifiers — each round's fit tolerates an
    ε-error slack (soft-margin: fixed λ, no hard-margin annealing) and ships
    the support points of the *slack-margin band* rather than the exact
    margin.  Termination accepts any classifier whose measured global error
    is within ε of the best seen so far (the noise floor is unknowable
    without labels, so the budget is relative).  Each fit is
    :func:`repro_torch.core.classifiers._svm_solve` on ``device`` (one
    Pegasos stage at B=1, 3000 steps, λ = 1e-2).
    """
    dev = _device.resolve(device)
    nodes, log = make_nodes(shards[:2])
    A, B = nodes
    n_total = A.n + B.n
    budget = int(np.floor(eps * n_total))

    def soft_fit(X, y):
        w, b = clf._svm_solve(_on(X, dev, torch.float32),
                              _on(y, dev, torch.float32), 1e-2, 3000)
        return clf.LinearSeparator(w.cpu().double().numpy(), float(b))

    best_h, best_err = None, 10 ** 9
    for rnd in range(max_rounds):
        log.new_round()
        src, dst = (A, B) if rnd % 2 == 0 else (B, A)
        Xk, yk = src.all_known()
        h = soft_fit(Xk, yk)
        # ship points inside the slack band (|functional margin| <= 1 + slack)
        m = yk * (Xk @ h.w + h.b)
        scale = max(np.median(np.abs(m)), 1e-9)
        band = np.where(np.abs(m) / scale <= 1.0 + noise_margin)[0]
        order = band[np.argsort(np.abs(m[band]))][:max_support]
        if len(order):
            src.send_points(dst, Xk[order], yk[order], tag="noisy-support")
        err = int(h.error(src.X, src.y) * src.n) + int(h.error(dst.X, dst.y) * dst.n)
        if err < best_err:
            best_err, best_h = err, h
        dst.send_bit(src, int(err <= best_err + budget), tag="noisy-accept")
        if rnd >= 3 and err <= best_err + budget and err <= 2 * budget + best_err:
            return ProtocolResult(best_h, log.summary(), rounds=rnd + 1,
                                  converged=True, extra={"best_err": best_err})
    return ProtocolResult(best_h, log.summary(), rounds=max_rounds,
                          converged=False, extra={"best_err": best_err})
