"""One-way chain protocols and the §7 baselines on tensors (counterpart of
``repro.engine.oneway``).

The paper's other half (§2–3, §6.1 RANDOM ε-net sampling; §7 NAIVE /
VOTING / MIXING baselines) is one-way: data flows down a fixed chain
P_1 → … → P_k (or star-in to P_k) and only the last node learns.  There is
no turn loop: a sweep is one chain pass plus one batched terminal fit.

* **Reservoir chain** (selector ``"sampling"``, paper Thm 3.1/6.1): a
  reservoir sampler batched over B with per-instance capacities s_ε,
  advanced over the k−1 chain hops in a Python loop (k is static).  Each
  hop ingests shard i under Vitter's j ~ U[0, t) rule — fill phase first,
  last-write-wins on slot collisions through a scatter-max of stream
  positions — and meters the reservoir forward at the host loop's message
  slot: ``min(seen, s_ε)`` points, one message, one round per hop.  The
  draws are ``jax.random.randint`` bit for bit (:mod:`repro_torch.core.prng`),
  so a reservoir equals the JAX package's row for row.
* **Star baselines** (``"naive"``, ``"voting"``, ``"mixing"``): closed-form
  metering at the host loops' slots (all points / all points / k−1
  parameter vectors) plus the batched terminal or per-node fits.

Every fit is one :func:`repro_torch.core.classifiers._svm_solve_batch`
call, so on the card a sweep's fit is one Pegasos-stage kernel launch per λ
stage (VOTING and MIXING fold their B·k per-node fits into one (B·k)-batch
solve).  Label-0 rows are inert in the fit and never enter the reservoir
(stream positions count valid rows only); unfilled reservoir slots keep
label 0, so the terminal fit set needs no compaction.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch

from repro_torch import _device
from repro_torch.core import prng
from repro_torch.core.classifiers import LinearSeparator, _svm_solve_batch
from repro_torch.core.sampling import EPSILON_NET_C, epsilon_net_size
from repro_torch.engine.state import (
    BatchCommLog,
    ProtocolInstance,
    _pack_shards,
    _round_up,
    _shared_k_d,
)

ONEWAY_SELECTORS = ("sampling", "naive", "voting", "mixing")
_I32 = torch.int32


def _pack(instances, dev):
    """A bucket's shards on ``dev``, padded onto (B, k, n_max, d) with
    label-0 rows: ``(X, y, k, d)``.  Instances share k and d (any d)."""
    k, ds = _shared_k_d(instances)
    if len(ds) != 1:
        raise ValueError(f"instances must share the dimension, got {ds}")
    d = ds.pop()
    X, y, _budget = _pack_shards(instances, d)
    return torch.from_numpy(X).to(dev), torch.from_numpy(y).to(dev), k, d


def _selector(instances) -> str:
    """The one-way selector that a bucket's instances share."""
    sels = {inst.selector for inst in instances}
    if len(sels) != 1:
        raise ValueError(f"one bucket must share a selector, got {sels}")
    sel = sels.pop()
    if sel not in ONEWAY_SELECTORS:
        raise ValueError(f"not a one-way selector: {sel!r}")
    return sel


def _zeros_comm(B: int, dev) -> BatchCommLog:
    return BatchCommLog(*(torch.zeros((B,), dtype=_I32, device=dev)
                          for _ in BatchCommLog._fields))


# ---------------------------------------------------------------------------
# batched reservoir (Vitter 1985 on the device)
# ---------------------------------------------------------------------------

def _make_ingest(cap: int):
    """Shard ingest with static capacity bound ``cap``, batched over the
    leading axis; each instance's effective capacity ``capb`` ≤ cap masks
    the tail slots."""

    def ingest(resX, resy, seen, key, Xi, yi, capb):
        # resX (B, cap, d), resy (B, cap), seen (B,), key (B, 2),
        # Xi (B, n_max, d), yi (B, n_max), capb (B,)
        B, n_max = yi.shape
        valid = yi != 0
        # 1-based global stream position of each valid row (padding rows
        # get a stale position but are masked out of every write below)
        t = seen[:, None] + torch.cumsum(valid.to(_I32), dim=1, dtype=_I32)
        draw = prng.randint(key, (n_max,), 0, torch.clamp(t, min=1))
        cb = capb[:, None]
        j = torch.where(t <= cb, t - 1, draw)        # fill phase is positional
        hit = valid & (j < cb)
        # last-write-wins on slot collisions = sequential order: the slot
        # keeps the item with the greatest stream position (a scatter-max
        # is well defined under duplicate indices, a scatter-set is not)
        tgt = torch.where(hit, j, cap).long()        # out-of-range: dropped
        rows = torch.arange(n_max, dtype=_I32, device=yi.device)[None, :]
        pos = torch.where(hit, rows, -1)
        winner = torch.full((B, cap + 1), -1, dtype=_I32, device=yi.device)
        winner = winner.scatter_reduce(1, tgt, pos, reduce="amax")[:, :cap]
        take = winner >= 0
        safe = winner.clamp_min(0).long()
        resX = torch.where(take[:, :, None],
                           Xi.gather(1, safe[:, :, None].expand(
                               -1, -1, Xi.shape[2])), resX)
        resy = torch.where(take, yi.gather(1, safe), resy)
        return resX, resy, seen + valid.sum(dim=1, dtype=_I32)

    return ingest


def chain_reservoir(X, y, caps, keys, *, k: int, cap: int):
    """The RANDOM ε-net chain up to the terminal fit (paper Thm 3.1, k-party
    Thm 6.1): P_i forwards a reservoir over ∪_{j≤i} D_j.  ``X`` (B, k,
    n_max, d), ``y`` (B, k, n_max), ``caps`` (B,) the ε-net sizes, ``keys``
    (B, 2) the instances' keys.  Returns the fit set of P_k, its own shard
    then the reservoir, ``(Kx (B, n_max + cap, d), Ky (B, n_max + cap))``,
    and the chain's :class:`BatchCommLog`."""
    B, _, _, d = X.shape
    dev = X.device
    resX = torch.zeros((B, cap, d), dtype=X.dtype, device=dev)
    resy = torch.zeros((B, cap), dtype=_I32, device=dev)
    seen = torch.zeros((B,), dtype=_I32, device=dev)
    comm = _zeros_comm(B, dev)
    if k > 1:
        ingest = _make_ingest(cap)
        hop_keys = prng.split(keys, k - 1)               # (B, k-1, 2)
        for i in range(k - 1):
            resX, resy, seen = ingest(resX, resy, seen, hop_keys[:, i],
                                      X[:, i], y[:, i], caps)
            # the host loop's message slot: P_i ships its current reservoir
            # (possibly empty — still one message) and the hop is one round
            comm = comm._replace(
                points=comm.points + torch.minimum(seen, caps),
                messages=comm.messages + 1, rounds=comm.rounds + 1)
    Kx = torch.cat([X[:, k - 1], resX], dim=1)
    Ky = torch.cat([y[:, k - 1], resy], dim=1)
    return Kx, Ky, comm


def _sampling_chain(instances, X, y, vc_dim, c):
    """The chain of a "sampling" bucket packed as ``X``/``y``: ε-net sizes
    from each instance's ε (VC dimension ``vc_dim``, default d+1; constant
    ``c``), keys from its seed.  Returns ``(Kx, Ky, comm, sizes)``."""
    k, d = X.shape[1], X.shape[3]
    vc = vc_dim if vc_dim is not None else d + 1
    cc = c if c is not None else EPSILON_NET_C
    sizes = [epsilon_net_size(inst.eps, vc, c=cc) for inst in instances]
    caps = torch.tensor(sizes, dtype=_I32, device=X.device)
    keys = prng.prng_key([inst.seed for inst in instances], device=X.device)
    Kx, Ky, comm = chain_reservoir(X, y, caps, keys, k=k,
                                   cap=_round_up(max(sizes), 8))
    return Kx, Ky, comm, sizes


def _naive_fit_set(X, y, k: int):
    """NAIVE's central fit set: every node's shard, padded tails kept
    (label 0, inert), as (B, k·n_max, d) and (B, k·n_max)."""
    B, _, n_max, d = X.shape
    return X.reshape(B, k * n_max, d), y.reshape(B, k * n_max)


def _local_fit_sets(X, y, k: int):
    """VOTING's and MIXING's B·k per-node fit sets as one batch."""
    B, _, n_max, d = X.shape
    return X.reshape(B * k, n_max, d), y.reshape(B * k, n_max)


def fit_set(instances: Sequence[ProtocolInstance], *,
            vc_dim: Optional[int] = None, c: Optional[float] = None,
            device="cuda"):
    """The fit set ``(Kx, Ky)`` that :func:`run_instances` hands the solver
    for a one-selector bucket, on ``device``: RANDOM's own shard then the
    reservoir, NAIVE's k shards as one set per instance, VOTING's and
    MIXING's k shards as B·k sets; label 0 on padding and unfilled slots."""
    sel = _selector(instances)
    X, y, k, _d = _pack(instances, _device.resolve(device))
    if sel == "sampling":
        Kx, Ky, _comm, _sizes = _sampling_chain(instances, X, y, vc_dim, c)
        return Kx, Ky
    if sel == "naive":
        return _naive_fit_set(X, y, k)
    return _local_fit_sets(X, y, k)


def _run_naive(X, y, lam0, *, k: int, steps: int, stages: int):
    """NAIVE: every node ships its whole shard to P_k; central fit."""
    Kx, Ky = _naive_fit_set(X, y, k)
    w, b, ok = _svm_solve_batch(Kx, Ky.to(Kx.dtype), lam0, steps, stages)
    return w, b, ok, _star_points_comm(y, k)


def _local_fits(X, y, lam0, *, k: int, steps: int, stages: int):
    """The B·k per-node fits of VOTING and MIXING as one batched solve."""
    B, d = X.shape[0], X.shape[3]
    Kx, Ky = _local_fit_sets(X, y, k)
    w, b, ok = _svm_solve_batch(Kx, Ky.to(Kx.dtype), lam0, steps, stages)
    return w.reshape(B, k, d), b.reshape(B, k), ok.reshape(B, k)


def _run_voting(X, y, lam0, *, k: int, steps: int, stages: int):
    """VOTING: B·k local fits as one batched solve; the vote is evaluated
    on the full dataset, which the paper charges at full data cost."""
    w, b, ok = _local_fits(X, y, lam0, k=k, steps=steps, stages=stages)
    return w, b, ok, _star_points_comm(y, k)


def _run_mixing(X, y, lam0, *, k: int, steps: int, stages: int):
    """MIXING: B·k local fits, ship normalized (w_i, b_i), average."""
    B, d = X.shape[0], X.shape[3]
    w, b, _ok = _local_fits(X, y, lam0, k=k, steps=steps, stages=stages)
    nrm = torch.sqrt((w * w).sum(dim=2)) + 1e-12
    w_mix = (w / nrm[:, :, None]).mean(dim=1)
    b_mix = (b / nrm).mean(dim=1)
    z = torch.zeros((B,), dtype=_I32, device=X.device)
    comm = BatchCommLog(points=z, scalars=z + (k - 1) * (d + 1), bits=z,
                        messages=z + (k - 1), rounds=z + 1)
    return w_mix, b_mix, comm


def _star_points_comm(y, k: int) -> BatchCommLog:
    """k−1 star messages into P_k carrying every non-last shard's points —
    the NAIVE/VOTING cost row of Tables 2–4 (empty shards still cost their
    message slot, matching ``Node.send_points``)."""
    pts = (y[:, :-1] != 0).sum(dim=(1, 2), dtype=_I32)
    z = torch.zeros_like(pts)
    return BatchCommLog(points=pts, scalars=z, bits=z,
                        messages=z + (k - 1), rounds=z + 1)


# ---------------------------------------------------------------------------
# sweep entry point
# ---------------------------------------------------------------------------

def run_instances(
    instances: Sequence[ProtocolInstance],
    *,
    eps: Optional[float] = None,
    vc_dim: Optional[int] = None,
    c: Optional[float] = None,
    steps: int = 2000,
    stages: int = 3,
    lam: float = 1e-3,
    device="cuda",
):
    """Run a batch of one-way/baseline instances as one sweep on ``device``.

    All instances must share one selector (``run_sweep`` buckets mixed
    sweeps), the party count k and the dimension d (any d).  Returns
    :class:`~repro_torch.core.protocols.one_way.ProtocolResult` per
    instance, shaped exactly like the JAX package's.  ``vc_dim`` and ``c``
    parameterize the ``"sampling"`` ε-net size as on the host API; each
    instance's random stream is keyed by ``ProtocolInstance.seed``.

    Launch-shape contract: the padded reservoir cap (the largest ε-net size
    of the batch, rounded up to 8), ``steps``, ``stages``, ``k``, ``d`` and
    the padded shard size fix every launch's shape; shard contents,
    per-instance caps, seeds, ``lam`` and B are data.
    """
    from repro_torch.core.protocols.baselines import (
        _MixedClassifier,
        _VotingClassifier,
    )
    from repro_torch.core.protocols.one_way import ProtocolResult

    dev = _device.resolve(device)
    sel = _selector(instances)
    if eps is not None:
        instances = [ProtocolInstance(inst.shards, eps, sel, inst.seed)
                     for inst in instances]
    X, y, k, d = _pack(instances, dev)
    B = len(instances)
    fit = dict(k=k, steps=steps, stages=stages)

    extra = {"engine": True, "batch": B, "selector": sel, "device": str(dev)}
    sizes = None
    if sel == "sampling":
        # RANDOM: the reservoir chain, then P_k fits on own ∪ reservoir
        Kx, Ky, comm, sizes = _sampling_chain(instances, X, y, vc_dim, c)
        w, b, _ok = _svm_solve_batch(Kx, Ky.to(Kx.dtype), lam, steps, stages)
    elif sel == "naive":
        w, b, _ok, comm = _run_naive(X, y, lam, **fit)
    elif sel == "voting":
        w, b, _ok, comm = _run_voting(X, y, lam, **fit)
    else:
        w, b, comm = _run_mixing(X, y, lam, **fit)

    w = w.cpu().double().numpy()
    b = b.cpu().double().numpy()
    summaries = comm.summaries(dim=d)
    rounds = k - 1 if sel == "sampling" else 1
    results: List[ProtocolResult] = []
    for i in range(B):
        if sel == "voting":
            h = _VotingClassifier([LinearSeparator(w[i, j], float(b[i, j]))
                                   for j in range(k)])
        elif sel == "mixing":
            h = _MixedClassifier(w[i], float(b[i]))
        else:
            h = LinearSeparator(w[i], float(b[i]))
        ex = dict(extra)
        if sizes is not None:
            ex["sample_size"] = sizes[i]
        results.append(ProtocolResult(h, summaries[i], rounds=rounds,
                                      converged=True, extra=ex))
    return results
