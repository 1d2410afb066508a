"""Baselines from the paper's experiments (§7) plus parameter-mixing (§8.1);
counterpart of ``repro.core.protocols.baselines``.

* NAIVE   — ship every point to the last node, learn centrally.
* VOTING  — each node learns locally; predictions are majority-voted with
            confidence tie-break (paper's (b)).
* RANDOM  — one-way ε-net sample (paper's (c); == protocols.one_way.random_sampling
            with the paper's (d/ε)log(d/ε) size).
* MIXING  — parameter averaging of local linear classifiers (McDonald et al.,
            Mann et al.; the paper's §8.1 comparison point).

With the default max-margin learner every baseline is the batched engine's
one-way path at B=1 on ``device`` (:mod:`repro_torch.engine.oneway`): the
per-node/terminal fits run as one batched annealed-Pegasos solve and
communication is metered in ``BatchCommLog`` at exactly these host message
slots.  A custom ``fit`` callable runs the metered host loops kept below.  Every
baseline meters its single one-way round (``log.new_round()``), so
``comm["rounds"]`` always equals ``ProtocolResult.rounds``.
"""

from __future__ import annotations

from typing import Callable, List, Optional

import numpy as np

from repro_torch.core import classifiers as clf
from repro_torch.core.comm import make_nodes
from repro_torch.core.protocols.one_way import ProtocolResult, random_sampling


def _engine_b1(shards, selector: str, device) -> ProtocolResult:
    from repro_torch import engine
    return engine.oneway.run_instances(
        [engine.ProtocolInstance(shards, selector=selector)],
        device=device)[0]


def naive(shards, fit: Optional[Callable] = None,
          device="cuda") -> ProtocolResult:
    if fit is None:
        return _engine_b1(shards, "naive", device)
    nodes, log = make_nodes(shards)
    log.new_round()
    last = nodes[-1]
    for nd in nodes[:-1]:
        nd.send_points(last, nd.X, nd.y, tag="naive-all")
    X, y = last.all_known()
    h = fit(X, y)
    return ProtocolResult(h, log.summary(), rounds=1, converged=True)


class _VotingClassifier:
    def __init__(self, parts: List[clf.LinearSeparator]):
        self.parts = parts

    def decision(self, X):
        return np.stack([h.decision(X) for h in self.parts], axis=0)

    def predict(self, X):
        dec = self.decision(X)
        votes = np.sign(dec)
        s = votes.sum(axis=0)
        # confidence tie-break: label whose prediction has higher |margin|
        conf = dec[np.argmax(np.abs(dec), axis=0), np.arange(dec.shape[1])]
        out = np.where(s != 0, np.sign(s), np.sign(conf))
        return np.where(out == 0, 1, out).astype(np.int32)

    def error(self, X, y):
        return float(np.mean(self.predict(np.atleast_2d(X)) != y)) if len(y) else 0.0


def voting(shards, fit: Optional[Callable] = None,
           device="cuda") -> ProtocolResult:
    """Local classifiers + majority vote.  Communication: every node ships its
    points' predictions?  No — the paper charges VOTING the full dataset cost
    (Tables 2-4 list Cost = all points), since evaluating the vote on D
    requires the data (or equivalently shipping every local classifier to
    every datum).  We meter it the same way."""
    if fit is None:
        return _engine_b1(shards, "voting", device)
    nodes, log = make_nodes(shards)
    log.new_round()
    parts = [fit(nd.X, nd.y) for nd in nodes]
    last = nodes[-1]
    for nd in nodes[:-1]:
        nd.send_points(last, nd.X, nd.y, tag="voting-eval")
    h = _VotingClassifier(parts)
    return ProtocolResult(h, log.summary(), rounds=1, converged=True)


def random(shards, eps: float = 0.05, seed: int = 0,
           device="cuda") -> ProtocolResult:
    """Paper's RANDOM: an ε-net of size (d/ε)log(d/ε) sent one-way.

    Same ``sampling.EPSILON_NET_C`` constant as ``one_way.random_sampling``
    (the entry points used to pass different c's into ``epsilon_net_size``,
    making Table 2's cost column depend on the API used)."""
    d = shards[0][0].shape[1]
    return random_sampling(shards, eps=eps, vc_dim=d, seed=seed,
                           device=device)


class _MixedClassifier(clf.LinearSeparator):
    pass


def mixing(shards, fit: Optional[Callable] = None,
           device="cuda") -> ProtocolResult:
    """Parameter averaging: each node ships (w_i, b_i); coordinator averages.
    Communication: k·(d+1) scalars — cheap, but no error guarantee under
    adversarial partitions (paper §8.1)."""
    if fit is None:
        return _engine_b1(shards, "mixing", device)
    nodes, log = make_nodes(shards)
    log.new_round()
    last = nodes[-1]
    ws, bs = [], []
    for nd in nodes:
        h = fit(nd.X, nd.y)
        wn = h.w / (np.linalg.norm(h.w) + 1e-12)
        bn = h.b / (np.linalg.norm(h.w) + 1e-12)
        ws.append(wn)
        bs.append(bn)
        if nd is not last:
            nd.send_scalars(last, np.concatenate([wn, [bn]]), tag="mixing-params")
    h = _MixedClassifier(np.mean(ws, axis=0), float(np.mean(bs)))
    return ProtocolResult(h, log.summary(), rounds=1, converged=True)
