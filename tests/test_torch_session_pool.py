"""The port's fault model, session pool and protocol service
(``repro_torch.engine.faults`` / ``session_pool``, ``repro_torch.serve``)
held against the JAX reference on the CPU, and the pool's own contract.

Sizes are ``tests/test_session_pool.py``'s and ``tests/test_unified.py``'s
(k 2, N_PAD 16, 64 angles, 8 epochs, 4 slots).  Tolerances:

* fault draws, statuses, session ledgers, pool stats, comm, rounds,
  convergence: exact against the JAX package;
* separators against the JAX pools: MEDIAN to atol 1e-5 (the JAX pool runs
  its fused step, tests/test_torch_median.py), MAXMARG and SAMPLING to a
  cosine above 1 - 1e-4 (tests/test_torch_maxmarg.py's tier);
* within the port: bit for bit — across admission orders, chaos survivors
  against the fault-free pool, checkpoint/restore, streamed ingest against
  direct submission.  That is the pool's contract: every turn launches
  the same operations at the same shapes whatever the batch holds.
"""

import os
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from repro.core import datasets
from repro.engine import faults as jF, session_pool as jsp
from repro.serve import ProtocolService as JService

from repro_torch.engine import faults as tF, hotloop as thot
from repro_torch.engine import session_pool as tsp
from repro_torch import serve as tserve
from repro_torch.serve import ProtocolService as TService

ROOT = Path(__file__).resolve().parents[1]
K = 2
N_PAD = 16
N_ANGLES = 64
MAX_EPOCHS = 8
COS = 1e-4
CHAOS = dict(seed=3, p_dropout=0.08, p_drop_msg=0.04, p_straggle=0.08,
             p_corrupt=0.03)
_GENS = (datasets.data1, datasets.data2, datasets.data3)
_MIX = ("median", "maxmarg", "sampling")


def _cfg(mod, **kw):
    base = dict(slots=4, k=K, n_pad=N_PAD, n_angles=N_ANGLES,
                max_epochs=MAX_EPOCHS)
    base.update(kw)
    return mod.PoolConfig(**base)


def _workload(n, seed=0, separable=True):
    """tests/test_session_pool.py's shared-separator instances, every shard
    exactly N_PAD rows; as (shards, eps, selector, seed) sessions."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        w = rng.normal(size=2)
        w /= np.linalg.norm(w)
        shards = []
        for _ in range(K):
            X = rng.normal(size=(N_PAD, 2)).astype(np.float32)
            if separable:
                yy = np.where(X @ w > 0, 1, -1).astype(np.int32)
            else:
                yy = rng.choice(np.array([-1, 1], np.int32), size=N_PAD)
            shards.append((X, yy))
        out.append((shards, None, None, 0))
    return out


def _mixed(n, seed0=0):
    """tests/test_unified.py's interleaved families."""
    return [(_GENS[i % 3](n_per_node=N_PAD, k=K, seed=seed0 + i),
             (0.1, 0.05, 0.05)[i % 3], _MIX[i % 3], seed0 + i)
            for i in range(n)]


def _pool(mod, work, schedule=None, run=True, **kw):
    dev = {} if mod is jsp else {"device": "cpu"}
    pool = mod.SessionPool(_cfg(mod, **kw), schedule, **dev)
    for shards, eps, sel, seed in work:
        pool.submit(shards, eps=eps, selector=sel, seed=seed)
    if run:
        pool.run()
    return pool


def _canon(h):
    v = np.concatenate([h.w, [h.b]])
    return v / (np.linalg.norm(v) + 1e-30)


def _bitwise(a, b):
    return (np.array_equal(np.asarray(a.classifier.w),
                           np.asarray(b.classifier.w))
            and float(a.classifier.b) == float(b.classifier.b)
            and a.comm == b.comm and a.rounds == b.rounds
            and a.converged == b.converged)


def _assert_pools_agree(pj, pt):
    """A JAX pool and a port pool that ran the same sessions: ledgers,
    stats and statuses exact, results at the tiers above."""
    assert pt.sessions == pj.sessions
    assert pt.stats == pj.stats
    assert set(pt.results) == set(pj.results)
    for sid, a in pj.results.items():
        b = pt.results[sid]
        sel = a.extra["selector"]
        assert a.comm == b.comm, (sid, sel)
        assert (a.rounds, a.converged) == (b.rounds, b.converged), sid
        assert b.extra == a.extra, sid
        if sel == "median":
            np.testing.assert_allclose(b.classifier.w, a.classifier.w,
                                       rtol=0, atol=1e-5)
            assert abs(b.classifier.b - a.classifier.b) <= 1e-5
        else:
            assert float(_canon(a.classifier) @ _canon(b.classifier)) \
                > 1.0 - COS, (sid, sel)


class ForcedSchedule:
    """tests/test_session_pool.py's duck-typed schedule: fire exactly at
    (sid, turn); a ``(sid, None)`` key fires on every turn."""

    straggle_max = 3
    any_faults = True

    def __init__(self, dropout=(), straggle=None, corrupt=None):
        self._drop = set(dropout)
        self._str = dict(straggle or {})
        self._cor = dict(corrupt or {})

    def _get(self, table, s, t, default):
        return table.get((s, t), table.get((s, None), default))

    def draws(self, sids, t):
        sids = [int(s) for s in np.asarray(sids)]
        return {
            "dropout": np.asarray([(s, t) in self._drop
                                   or (s, None) in self._drop
                                   for s in sids], bool),
            "drop_msg": np.zeros(len(sids), bool),
            "straggle": np.asarray([self._get(self._str, s, t, 0)
                                    for s in sids], np.int32),
            "corrupt": np.asarray([self._get(self._cor, s, t, -1)
                                   for s in sids], np.int32),
        }


# -- (a) the fault model -------------------------------------------------------

def test_faults_module_is_a_verbatim_copy():
    assert ((ROOT / "src/repro_torch/engine/faults.py").read_bytes()
            == (ROOT / "src/repro/engine/faults.py").read_bytes())


@pytest.mark.parametrize("seed", [0, 3, 12345])
def test_fault_draws_bitwise_equal_to_reference(seed):
    """Every channel over a grid of session ids and pool turns, and both
    JSON round trips."""
    kw = dict(seed=seed, p_dropout=0.1, p_drop_msg=0.05, p_straggle=0.2,
              straggle_max=4, p_corrupt=0.07)
    js, ts = jF.FaultSchedule(**kw), tF.FaultSchedule(**kw)
    sids = np.arange(0, 400, 3)
    for t in range(0, 60, 7):
        a, b = js.draws(sids, t), ts.draws(sids, t)
        assert a.keys() == b.keys()
        for ch in a:
            np.testing.assert_array_equal(b[ch], a[ch])
            assert b[ch].dtype == a[ch].dtype
    for a, b in ((tF.FaultSchedule.from_json(js.to_json()), js),
                 (jF.FaultSchedule.from_json(ts.to_json()), ts)):
        for ch, v in a.draws(sids, 9).items():
            np.testing.assert_array_equal(v, b.draws(sids, 9)[ch])
    assert ts.to_json() == js.to_json()
    assert not tF.FAULT_FREE.any_faults


# -- (b) fault-free pools against the JAX pools ------------------------------

@pytest.fixture(scope="module")
def unified_runs():
    work = _mixed(9, seed0=20)
    return work, _pool(jsp, work, selector="unified"), \
        _pool(tsp, work, selector="unified")


@pytest.mark.parametrize("selector", ["median", "maxmarg", "unified"])
def test_fault_free_pool_matches_reference(selector, unified_runs):
    if selector == "unified":
        _work, pj, pt = unified_runs
    else:
        kw = dict(selector=selector)
        if selector == "maxmarg":
            kw.update(slots=2, max_epochs=6)
        work = _workload(6, seed=1)
        pj, pt = _pool(jsp, work, **kw), _pool(tsp, work, **kw)
    _assert_pools_agree(pj, pt)
    assert all(r.extra["session_pool"] for r in pt.results.values())


# -- (c) the pool's contract within the port ---------------------------------

def test_admission_order_is_bitwise_invariant(unified_runs):
    """Reversed submission: other slots, other batch neighbours, the same
    bits for every session."""
    work, _pj, pt = unified_runs
    perm = list(reversed(range(len(work))))
    rev = _pool(tsp, [work[i] for i in perm], selector="unified")
    for j, i in enumerate(perm):
        assert _bitwise(rev.results[j], pt.results[i]), i


@pytest.fixture(scope="module")
def chaos_runs(unified_runs):
    work, _pj, clean = unified_runs
    thot.KEY_LOG.clear()
    runs = [_pool(tsp, work, tF.FaultSchedule(**CHAOS), selector="unified")
            for _ in range(2)]
    return work, clean, runs, list(thot.KEY_LOG)


def test_chaos_survivors_bitwise_vs_fault_free(chaos_runs):
    work, clean, (chaos, _again), _keys = chaos_runs
    assert chaos.stats["dropouts"] + chaos.stats["drop_msgs"] > 0
    assert chaos.stats["straggles"] > 0
    quarantined = 0
    for sid in range(len(work)):
        rec = chaos.sessions[sid]
        if rec["status"] == tsp.ST_QUARANTINED:
            quarantined += 1
            assert sid not in chaos.results
            assert rec["quarantine_reason"] is not None
        else:
            assert _bitwise(chaos.results[sid], clean.results[sid]), sid
    assert quarantined == chaos.stats["quarantined"]


def test_chaos_two_runs_identical_and_as_the_reference(chaos_runs):
    """Same seed: the same ledgers, stats and bits — and the JAX pool's
    ledgers and stats under the same schedule."""
    work, _clean, (a, b), _keys = chaos_runs
    assert a.stats == b.stats and a.sessions == b.sessions
    assert set(a.results) == set(b.results)
    for sid in a.results:
        assert _bitwise(a.results[sid], b.results[sid]), sid
    pj = _pool(jsp, work, jF.FaultSchedule(**CHAOS), selector="unified")
    _assert_pools_agree(pj, a)


@pytest.mark.parametrize("kind,reason", [
    (tF.CORRUPT_NAN, "nan_separator"),
    (tF.CORRUPT_FILL, "fill_regression"),
    (tF.CORRUPT_COMM, "comm_blowout"),
], ids=["nan", "fill", "comm"])
def test_corruption_kind_trips_its_invariant(kind, reason):
    """Non-separable sessions run their whole budget, so the corruption at
    pool turn 1 cannot race a convergence; bystanders keep their bits."""
    work = _workload(3, seed=6, separable=False)
    pool = _pool(tsp, work, ForcedSchedule(corrupt={(1, 1): kind}))
    rec = pool.sessions[1]
    assert rec["status"] == tsp.ST_QUARANTINED
    assert rec["quarantine_reason"] == reason
    assert rec["corrupt_kind"] == kind
    assert 1 not in pool.results
    assert pool.stats["quarantined"] == pool.stats["corruptions"] == 1
    clean = _pool(tsp, work)
    for sid in (0, 2):
        assert pool.sessions[sid]["status"] == clean.sessions[sid]["status"]
        assert _bitwise(pool.results[sid], clean.results[sid])


def test_dropout_escalates_to_retry_budget_quarantine():
    """A session dropped every turn walks the backoff ladder (retries at
    pool turns 0, 2, 5, 10) and quarantines on the budget+1-th."""
    pool = _pool(tsp, _workload(2, seed=7),
                 ForcedSchedule(dropout={(0, None)}))
    rec = pool.sessions[0]
    budget = pool.cfg.retry_budget
    assert rec["status"] == tsp.ST_QUARANTINED
    assert rec["quarantine_reason"] == "retry_budget"
    assert rec["retries"] == rec["dropouts"] == budget + 1
    assert rec["backoffs"] == budget
    assert rec["turns"] == 0 and 0 not in pool.results
    assert rec["evicted_turn"] == sum(1 + (1 << i) for i in range(budget))
    assert pool.sessions[1]["status"] == tsp.ST_CONVERGED


def test_straggler_delays_without_a_retry():
    work = _workload(2, seed=9)
    pool = _pool(tsp, work, ForcedSchedule(straggle={(0, 1): 2}))
    clean = _pool(tsp, work)
    rec = pool.sessions[0]
    assert rec["status"] == tsp.ST_CONVERGED
    assert rec["straggles"] == 1
    assert rec["retries"] == 0 and rec["backoffs"] == 0
    assert _bitwise(pool.results[0], clean.results[0])
    assert rec["evicted_turn"] == clean.sessions[0]["evicted_turn"] + 3


def test_checkpoint_restore_resumes_bitwise(tmp_path):
    """A chaotic mixed pool snapshotted mid-stream (live slots, pending
    queue, partial results) finishes as the uninterrupted one."""
    work = _mixed(9, seed0=60)
    a = _pool(tsp, work, tF.FaultSchedule(**CHAOS), run=False,
              selector="unified")
    for _ in range(2):
        a.step_pool()
    assert a.pending and not a.drained()
    a.checkpoint(str(tmp_path))
    b = tsp.SessionPool.restore(str(tmp_path), device="cpu")
    assert b.pool_turn == a.pool_turn
    np.testing.assert_array_equal(b.slot_sel, a.slot_sel)
    a.run()
    b.run()
    assert a.stats == b.stats and a.sessions == b.sessions
    assert set(a.results) == set(b.results)
    for sid in a.results:
        assert _bitwise(a.results[sid], b.results[sid]), sid
        assert a.results[sid].extra == b.results[sid].extra


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_checkpoints_restore_across_packages(tmp_path, unified_runs, writer):
    """A mid-stream checkpoint written by one package's pool (JAX's flat
    keys, uint32 hop keys) restores in the other's and finishes within
    the tiers of that package's uninterrupted run."""
    work, pj_full, pt_full = unified_runs
    mod = jsp if writer == "jax" else tsp
    a = _pool(mod, work, run=False, selector="unified")
    for _ in range(2):
        a.step_pool()
    assert a.pending and a.results
    a.checkpoint(str(tmp_path))
    keys = np.load(str(tmp_path / "pool_00000002.npz"))["state/.hop_keys"]
    assert keys.dtype == np.uint32
    if writer == "jax":
        b = tsp.SessionPool.restore(str(tmp_path), device="cpu")
        assert b.state.hop_keys.dtype == torch.int64
        np.testing.assert_array_equal(b.state.hop_keys.numpy(),
                                      np.asarray(a.state.hop_keys, np.int64))
        b.run()
        _assert_pools_agree(pj_full, b)
    else:
        b = jsp.SessionPool.restore(str(tmp_path))
        np.testing.assert_array_equal(np.asarray(b.state.hop_keys),
                                      a.state.hop_keys.numpy())
        b.run()
        _assert_pools_agree(b, pt_full)


def test_key_log_holds_one_shape_over_saturated_runs(chaos_runs):
    """Two chaotic runs of a pool that starts saturated (9 sessions, 4
    slots) record one launch shape, once a dispatch."""
    _work, _clean, runs, keys = chaos_runs
    assert set(keys) == {(4, runs[0].cfg.cap, False, False)}
    assert len(keys) == sum(p.stats["dispatches"] for p in runs) > 2


# -- (d) the protocol service --------------------------------------------------

def _shards(seed, n=N_PAD):
    rng = np.random.default_rng(seed)
    w = rng.normal(size=2)
    w /= np.linalg.norm(w)
    out = []
    for _ in range(K):
        X = rng.normal(size=(n, 2)).astype(np.float32)
        out.append((X, np.where(X @ w > 0, 1, -1).astype(np.int32)))
    return out


def _svc(cls, **kw):
    dev = {} if cls is JService else {"device": "cpu"}
    return cls(_cfg(tsp if cls is TService else jsp, **kw), **dev)


def test_service_streamed_ingest_equals_direct_submit():
    svc, direct = _svc(TService), _svc(TService)
    sids = []
    for seed in range(5):
        shards = _shards(seed)
        h = svc.open()
        for node, (X, y) in enumerate(shards):
            for lo in range(0, N_PAD, 5):          # ragged chunks
                svc.feed(h, node, X[lo:lo + 5], y[lo:lo + 5])
        sids.append((svc.close(h), direct.submit(shards)))
    svc.run()
    direct.run()
    for sa, sb in sids:
        assert svc.status(sa) == "converged"
        assert _bitwise(svc.result(sa), direct.result(sb))


def test_service_reservoir_rows_equal_reference():
    """Oversized mixed streams (10 x 24 rows a node into 16-row
    reservoirs): the port admits JAX's rows, and both services' results
    agree at the tiers."""
    streams = {}
    outs = []
    for cls in (JService, TService):
        svc = _svc(cls, selector="unified")
        rng = np.random.default_rng(0)
        for i in range(6):
            h = svc.open(selector=_MIX[i % 3], seed=i,
                         eps=(0.1, 0.05, 0.05)[i % 3])
            w = rng.normal(size=2)
            for node in range(K):
                for _ in range(10):
                    X = rng.normal(size=(24, 2)).astype(np.float32)
                    svc.feed(h, node, X, np.where(X @ w > 0, 1, -1))
            svc.close(h)
        streams[cls] = [(p.X.copy(), p.y.copy()) for p in svc.pool.pending]
        svc.run()
        outs.append(svc.pool)
    for (Xa, ya), (Xb, yb) in zip(*streams.values()):
        np.testing.assert_array_equal(Xb, Xa)
        np.testing.assert_array_equal(yb, ya)
    _assert_pools_agree(*outs)


def test_service_oversized_stream_downsamples_at_pinned_shape():
    svc = TService(_cfg(tsp), ingest_seed=1, device="cpu")
    rng = np.random.default_rng(0)
    w = rng.normal(size=2)
    h = svc.open()
    for node in range(K):
        for _ in range(10):                       # 10 * 64 points a node
            X = rng.normal(size=(64, 2)).astype(np.float32)
            svc.feed(h, node, X, np.where(X @ w > 0, 1, -1))
    assert svc._open[h].reservoirs[0].seen == 640
    sid = svc.close(h)
    assert svc.pool.pending[0].X.shape == (K, N_PAD, 2)
    svc.run()
    assert svc.status(sid) == "converged"
    assert svc.stats["admitted"] == 1


def test_service_checkpoint_refuses_open_handles(tmp_path):
    svc = _svc(TService)
    h = svc.open()
    with pytest.raises(RuntimeError, match="still open"):
        svc.checkpoint(str(tmp_path))
    svc.feed(h, 0, np.zeros((1, 2), np.float32), np.ones(1))
    svc.feed(h, 1, np.zeros((1, 2), np.float32), np.ones(1))
    svc.close(h)
    svc.checkpoint(str(tmp_path))
    restored = TService.restore(str(tmp_path), device="cpu")
    restored.run()
    assert len(restored.pool.results) == 1


def _raised(fn):
    try:
        fn()
    except Exception as e:          # the message is what is compared
        return type(e).__name__, str(e)
    return None


def _service_calls(svc):
    shards = _shards(3)
    X = np.zeros((4, 2), np.float32)
    ok = np.ones((4,), np.int32)
    calls = [
        lambda: svc.open(reservoir_capacity=N_PAD + 1),
        lambda: svc.feed(svc.open(), 2, X[:1], ok[:1]),
        lambda: svc.close(svc.open()),
        lambda: svc.submit([(X, ok)]),
        lambda: svc.submit([(np.zeros((N_PAD + 1, 2), np.float32),
                             np.ones((N_PAD + 1,), np.int32)), (X, ok)]),
        lambda: svc.submit([(X, np.array([1, 0, 1, 1])), (X, ok)]),
        lambda: svc.submit([(np.zeros((4, 3), np.float32), ok), (X, ok)]),
        lambda: svc.submit(shards, selector="maxmarg"),
        lambda: svc.submit(shards, selector="voting"),
        lambda: svc.submit(shards, eps=1e-4, selector="sampling"),
    ]
    return [_raised(c) for c in calls]


@pytest.mark.parametrize("selector", ["median", "unified"])
def test_validation_errors_are_the_references(selector):
    """The same calls raise the same errors with the same messages."""
    got = _service_calls(_svc(TService, selector=selector))
    want = _service_calls(_svc(JService, selector=selector))
    assert got == want
    assert sum(g is not None for g in got) >= 8
    for bad in (dict(selector="bogus"), dict(d=3),
                dict(slots=0), dict(checkpoint_every=2)):
        assert _raised(lambda: _cfg(tsp, **bad)) == \
            _raised(lambda: _cfg(jsp, **bad))


def test_serve_exports():
    assert tserve.ProtocolService is TService
    assert tserve.PoolConfig is tsp.PoolConfig
    assert tserve.FaultSchedule is tF.FaultSchedule
    assert tserve.ServingEngine is tserve.TokenServingEngine
    assert "ProtocolService" in (tserve.engine.__doc__ or "")
