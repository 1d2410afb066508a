"""One-way protocols (paper §2, §3, §6.1); counterpart of
``repro.core.protocols.one_way``.

All protocols communicate down a fixed chain P_1 → P_2 → … → P_k (two-party
is k=2) and the *last* node outputs the classifier.  Costs are metered by the
shared :class:`~repro_torch.core.comm.CommLog`; every chain hop is one
``log.new_round()``, so ``summary()["rounds"]`` always equals the
``ProtocolResult.rounds`` field (the metering contract the engine's
``BatchCommLog`` reproduces slot-for-slot).

The max-margin protocols run on the batched engine
(:mod:`repro_torch.engine.oneway`) with B=1 on ``device``; the threshold,
interval and rectangle protocols and a custom ``fit`` run the metered host
loops, in numpy.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, List, Optional

import numpy as np

from repro_torch.core import classifiers as clf
from repro_torch.core import sampling
from repro_torch.core.comm import make_nodes


@dataclasses.dataclass
class ProtocolResult:
    classifier: Any
    comm: dict
    rounds: int
    converged: bool
    extra: Optional[dict] = None

    def error_on(self, X: np.ndarray, y: np.ndarray) -> float:
        return self.classifier.error(X, y)

    def accuracy_on(self, X: np.ndarray, y: np.ndarray) -> float:
        return 1.0 - self.error_on(X, y)


# ---------------------------------------------------------------------------
# Theorem 2.1 — random partition: learn locally, communicate nothing
# ---------------------------------------------------------------------------

def local_only(shards, fit: Optional[Callable] = None,
               device="cuda") -> ProtocolResult:
    """P_1 learns on its own shard (the max-margin learner on ``device``
    unless ``fit`` is given) and nothing is sent."""
    nodes, log = make_nodes(shards)
    if fit is None:
        h = clf.fit_max_margin(nodes[0].X, nodes[0].y, device=device)
    else:
        h = fit(nodes[0].X, nodes[0].y)
    return ProtocolResult(h, log.summary(), rounds=0, converged=True)


# ---------------------------------------------------------------------------
# Theorem 3.1 / 6.1 — ε-net sampling down the chain (reservoir for k-party)
# ---------------------------------------------------------------------------

def random_sampling(
    shards,
    eps: float,
    vc_dim: Optional[int] = None,
    fit: Optional[Callable] = None,
    seed: int = 0,
    c: float = sampling.EPSILON_NET_C,
    device="cuda",
) -> ProtocolResult:
    """P_i forwards a reservoir sample of ∪_{j<=i} D_j; P_k fits on
    reservoir ∪ D_k.  Two-party instance is exactly paper Thm 3.1.

    With the default max-margin learner this is the batched engine's
    ``"sampling"`` selector at B=1 on ``device``
    (:mod:`repro_torch.engine.oneway`: reservoir chain + batched terminal
    fit, the same comm metering).  A custom ``fit`` callable runs the
    metered host chain below instead, with numpy's generator.
    """
    if fit is None:
        from repro_torch import engine
        return engine.oneway.run_instances(
            [engine.ProtocolInstance(shards, eps, "sampling", seed)],
            vc_dim=vc_dim, c=c, device=device)[0]

    nodes, log = make_nodes(shards)
    d = nodes[0].d
    vc = vc_dim if vc_dim is not None else d + 1
    s_eps = sampling.epsilon_net_size(eps, vc, c=c)
    rng = np.random.default_rng(seed)

    res = sampling.Reservoir(s_eps, d, rng)
    for i, node in enumerate(nodes[:-1]):
        log.new_round()
        res.add_batch(node.X, node.y)
        RX, Ry = res.sample()
        node.send_points(nodes[i + 1], RX, Ry, tag="reservoir")
        # chain semantics: next node's reservoir continues from the stream;
        # the received points already live in nodes[i+1].recv_*
    last = nodes[-1]
    X = np.concatenate([last.X, last.recv_X])
    y = np.concatenate([last.y, last.recv_y])
    h = fit(X, y)
    return ProtocolResult(h, log.summary(), rounds=len(nodes) - 1, converged=True,
                          extra={"sample_size": s_eps})


# ---------------------------------------------------------------------------
# Lemma 3.1 / Thm 6.2 — thresholds, 0-error, O(1) per hop
# ---------------------------------------------------------------------------

def threshold_protocol(shards) -> ProtocolResult:
    """Each node forwards its largest positive and smallest negative."""
    nodes, log = make_nodes(shards)
    for i, node in enumerate(nodes[:-1]):
        log.new_round()
        X, y = node.all_known()
        x = X.reshape(-1)
        parts = []
        pos = x[y == 1]
        neg = x[y == -1]
        if len(pos):
            parts.append((pos.max(), 1))
        if len(neg):
            parts.append((neg.min(), -1))
        if parts:
            P = np.asarray([[p] for p, _ in parts])
            L = np.asarray([l for _, l in parts], dtype=np.int32)
            node.send_points(nodes[i + 1], P, L, tag="threshold-extremes")
    last = nodes[-1]
    X, y = last.all_known()
    h = clf.Threshold.fit(X, y)
    return ProtocolResult(h, log.summary(), rounds=len(nodes) - 1, converged=True)


# ---------------------------------------------------------------------------
# Lemma 3.2 — intervals: two threshold instances back to back
# ---------------------------------------------------------------------------

def interval_protocol(shards) -> ProtocolResult:
    """Each node forwards the 2 boundary pairs of its local optimal interval
    (or nothing, the paper's ∅ case)."""
    nodes, log = make_nodes(shards)
    for i, node in enumerate(nodes[:-1]):
        log.new_round()
        X, y = node.all_known()
        x = X.reshape(-1)
        pos = x[y == 1]
        neg = x[y == -1]
        sendx: List[float] = []
        sendy: List[int] = []
        if len(pos):
            a, b = pos.min(), pos.max()
            sendx += [a, b]
            sendy += [1, 1]
            # nearest blocking negatives on each side, if any
            left = neg[neg < a]
            right = neg[neg > b]
            if len(left):
                sendx.append(left.max()); sendy.append(-1)
            if len(right):
                sendx.append(right.min()); sendy.append(-1)
        if sendx:
            node.send_points(nodes[i + 1], np.asarray(sendx).reshape(-1, 1),
                             np.asarray(sendy, dtype=np.int32), tag="interval-endpoints")
    last = nodes[-1]
    X, y = last.all_known()
    h = clf.Interval.fit(X, y)
    return ProtocolResult(h, log.summary(), rounds=len(nodes) - 1, converged=True)


# ---------------------------------------------------------------------------
# Theorem 3.2 / 6.2 — axis-aligned rectangles, O(d) per hop
# ---------------------------------------------------------------------------

def rectangle_protocol(shards) -> ProtocolResult:
    """Each node forwards the corners of the minimum enclosing rectangles of
    its positives and negatives (2 points each = the paper's 4d values)."""
    nodes, log = make_nodes(shards)
    rect_p = rect_n = None
    for i, node in enumerate(nodes):
        rect_p = clf.AxisAlignedRectangle.merge(rect_p, clf.AxisAlignedRectangle.minimal(node.pos()))
        rect_n = clf.AxisAlignedRectangle.merge(rect_n, clf.AxisAlignedRectangle.minimal(node.neg()))
        if i == len(nodes) - 1:
            break
        log.new_round()
        pts, labs = [], []
        if rect_p is not None:
            pts += [rect_p[0], rect_p[1]]; labs += [1, 1]
        if rect_n is not None:
            pts += [rect_n[0], rect_n[1]]; labs += [-1, -1]
        if pts:
            node.send_points(nodes[i + 1], np.stack(pts), np.asarray(labs, dtype=np.int32),
                             tag="rect-corners")
    # decide polarity: the smaller enclosing box is the inside class (paper proof)
    def _vol(r):
        return float(np.prod(r[1] - r[0])) if r is not None else np.inf
    if rect_p is None:
        # the paper's ∅ sentinel on the positive class everywhere: the
        # minimal consistent rectangle is empty, so the hypothesis is the
        # degenerate always-negative box (lo > hi ⇒ nothing is inside) —
        # NOT a box around the negatives, whose outside would flip to +1
        d = nodes[0].d
        h = clf.AxisAlignedRectangle(np.full(d, np.inf), np.full(d, -np.inf),
                                     positive_inside=True)
    elif rect_n is None or _vol(rect_p) <= _vol(rect_n):
        h = clf.AxisAlignedRectangle.from_bounds(rect_p, positive_inside=True)
    else:
        h = clf.AxisAlignedRectangle.from_bounds(rect_n, positive_inside=False)
    return ProtocolResult(h, log.summary(), rounds=len(nodes) - 1, converged=True)
