"""The port's one-way family — RANDOM ε-net sampling and the §7 NAIVE /
VOTING / MIXING baselines (``repro_torch.engine.oneway``,
``core.protocols.one_way`` / ``baselines``) — against the JAX package on
the CPU, on the same seeded numpy shards.

Tolerances:

* comm dicts, rounds, ``converged`` and ``sample_size``: exact;
* the reservoir chain (every hop's reservoir, ``seen``, the terminal fit
  set): bit for bit — the port draws with JAX's Threefry
  (tests/test_torch_prng.py);
* separators within 1e-4 of the instance's largest |w_i|, |b|: both sides
  run the classic solver loop on the CPU, and XLA contracts its
  multiply-adds and sums in its own order (tests/test_torch_solver.py);
* the host protocols (thresholds, intervals, rectangles, custom ``fit``
  chains) are numpy on both sides: classifiers exact, or at the solver
  tier where the custom fit is the max-margin solver.
"""

import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp

from repro import engine as jeng
from repro.core import classifiers as jclf, datasets
from repro.core.protocols import baselines as jbase, one_way as jone

import torch

from repro_torch import engine as teng
from repro_torch.core import classifiers as tclf, prng, sampling as tsamp
from repro_torch.core.protocols import baselines as tbase, one_way as tone
from repro_torch.engine import oneway as toneway

REL = 1e-4
CPU = dict(device="cpu")


def _grid(selector, k=2, n=40):
    """dataset × ε × seed: 6 instances, ragged in one shard."""
    out = []
    for g, gen in enumerate((datasets.data1, datasets.data2, datasets.data3)):
        for eps in (0.1, 0.05):
            shards = gen(n_per_node=n, k=k, seed=g)
            if g == 1:
                shards = [(shards[0][0][:n - 7], shards[0][1][:n - 7])] \
                    + list(shards[1:])
            out.append((shards, eps, selector, 10 * g + int(eps * 100)))
    return out


def _both(args):
    return ([jeng.ProtocolInstance(*a) for a in args],
            [teng.ProtocolInstance(*a) for a in args])


def _parts(h):
    """(w, b) pairs of a separator or a vote."""
    parts = getattr(h, "parts", [h])
    return [(np.asarray(p.w, np.float64), float(p.b)) for p in parts]


def _assert_same(rj, rt):
    assert rt.comm == rj.comm, (rt.comm, rj.comm)
    assert (rt.rounds, rt.converged) == (rj.rounds, rj.converged)
    assert type(rt.classifier).__name__ == type(rj.classifier).__name__
    for (wj, bj), (wt, bt) in zip(_parts(rj.classifier),
                                  _parts(rt.classifier), strict=True):
        va, vb = np.append(wj, bj), np.append(wt, bt)
        assert np.abs(va - vb).max() <= REL * np.abs(va).max(), (va, vb)


# -- the reservoir chain ------------------------------------------------------

def _chain_inputs(B=5, k=4, n=24, d=2, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(B, k, n, d)).astype(np.float32)
    y = rng.choice([-1, 1], size=(B, k, n)).astype(np.int32)
    y[0, :, 17:] = 0                          # ragged shards
    y[1, 1] = 0                               # an empty shard
    y[2, :, ::3] = 0                          # padding between valid rows
    caps = np.array([5, 30, 1, 12, 48], np.int32)   # fill, overflow, tiny
    seeds = [3, 0, 11, 2 ** 31 - 1, 7]
    return X, y, caps, seeds


def test_ingest_matches_reference_hop_by_hop():
    """``_make_ingest`` against JAX's vmapped ``oneway._make_ingest`` on the
    same hop keys: reservoir and ``seen`` bit-equal after every hop."""
    X, y, caps, seeds = _chain_inputs()
    B, k, _, d = X.shape
    cap = 48
    jkeys = jnp.stack([jax.random.PRNGKey(s) for s in seeds])
    jhop = jax.vmap(lambda kk: jax.random.split(kk, k - 1))(jkeys)
    thop = prng.split(prng.prng_key(seeds), k - 1)
    np.testing.assert_array_equal(thop.numpy(), np.asarray(jhop))
    jing = jax.jit(jax.vmap(jeng.oneway._make_ingest(cap)))
    ting = toneway._make_ingest(cap)
    js = (jnp.zeros((B, cap, d)), jnp.zeros((B, cap), jnp.int32),
          jnp.zeros((B,), jnp.int32))
    ts = (torch.zeros((B, cap, d)), torch.zeros((B, cap), dtype=torch.int32),
          torch.zeros((B,), dtype=torch.int32))
    for i in range(k):
        js = jing(*js, jhop[:, i % (k - 1)], jnp.asarray(X[:, i]),
                  jnp.asarray(y[:, i]), jnp.asarray(caps))
        ts = ting(*ts, thop[:, i % (k - 1)], torch.from_numpy(X[:, i]),
                  torch.from_numpy(y[:, i]), torch.from_numpy(caps))
        for a, b in zip(js, ts):
            np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    # past the fill phase: the tiny and mid-size reservoirs were overwritten
    assert (ts[2].numpy() > caps).any()


def test_chain_reservoir_fit_set_and_metering():
    """The terminal fit set (own shard, then the reservoir) and the chain's
    metering, against a replay of JAX's ``_run_sampling`` chain."""
    X, y, caps, seeds = _chain_inputs(seed=1)
    B, k, _, d = X.shape
    cap = 48
    Kx, Ky, comm = toneway.chain_reservoir(
        torch.from_numpy(X), torch.from_numpy(y), torch.from_numpy(caps),
        prng.prng_key(seeds), k=k, cap=cap)
    ing = jax.vmap(jeng.oneway._make_ingest(cap))
    hop = jax.vmap(lambda kk: jax.random.split(kk, k - 1))(
        jnp.stack([jax.random.PRNGKey(s) for s in seeds]))
    rX, ry, sn = (jnp.zeros((B, cap, d)), jnp.zeros((B, cap), jnp.int32),
                  jnp.zeros((B,), jnp.int32))
    pts = np.zeros(B, np.int64)
    for i in range(k - 1):
        rX, ry, sn = ing(rX, ry, sn, hop[:, i], jnp.asarray(X[:, i]),
                         jnp.asarray(y[:, i]), jnp.asarray(caps))
        pts += np.minimum(np.asarray(sn), caps)
    np.testing.assert_array_equal(
        Kx.numpy(), np.concatenate([X[:, k - 1], np.asarray(rX)], axis=1))
    np.testing.assert_array_equal(
        Ky.numpy(), np.concatenate([y[:, k - 1], np.asarray(ry)], axis=1))
    np.testing.assert_array_equal(comm.points.numpy(), pts)
    assert (comm.messages.numpy() == k - 1).all()
    assert (comm.rounds.numpy() == k - 1).all()


# -- run_instances per selector ----------------------------------------------

@pytest.mark.parametrize("selector,k", [
    ("sampling", 2), ("sampling", 3), ("sampling", 4), ("naive", 2),
    ("voting", 2), ("mixing", 2)])
def test_run_instances_matches_reference(selector, k):
    jinst, tinst = _both(_grid(selector, k=k))
    rj = jeng.oneway.run_instances(jinst)
    rt = toneway.run_instances(tinst, **CPU)
    for a, b in zip(rj, rt, strict=True):
        _assert_same(a, b)
        if selector == "sampling":
            assert b.extra["sample_size"] == a.extra["sample_size"]
        assert b.extra["engine"] and b.extra["batch"] == len(tinst)
        assert b.comm["rounds"] == b.rounds


@pytest.mark.parametrize("selector,k", [
    ("sampling", 2), ("sampling", 4), ("naive", 2), ("voting", 3),
    ("mixing", 2)])
def test_fit_set_is_what_run_instances_fits(selector, k):
    """``oneway.fit_set`` is the set the sweep hands the solver: its live
    rows are the shards (RANDOM: P_k's shard, then the reservoir), and a
    solve on it gives ``run_instances``' separators bit for bit."""
    _, tinst = _both(_grid(selector, k=k))
    opts = dict(steps=300, stages=2)
    Kx, Ky = toneway.fit_set(tinst, **CPU)
    B, n_max = len(tinst), max(len(sh[1]) for i in tinst for sh in i.shards)
    fits = B * k if selector in ("voting", "mixing") else B
    assert Kx.shape[:2] == Ky.shape and Kx.shape[0] == fits
    for f in range(fits):
        live = Ky[f] != 0
        if selector == "naive":
            want = [sh[1] for sh in tinst[f].shards]
        elif selector == "sampling":
            want = [tinst[f].shards[-1][1]]
        else:
            want = [tinst[f // k].shards[f % k][1]]
        got = Ky[f][:len(want[0])] if selector == "sampling" else Ky[f][live]
        np.testing.assert_array_equal(got.numpy(), np.concatenate(want))
        if selector == "sampling":
            seen = sum(len(sh[1]) for sh in tinst[f].shards[:-1])
            s_eps = tsamp.epsilon_net_size(tinst[f].eps, 3)
            assert int(live[n_max:].sum()) == min(seen, s_eps)
    w, b, _ok = tclf._svm_solve_batch(Kx, Ky.float(), 1e-3, **opts)
    res = toneway.run_instances(tinst, **opts, **CPU)
    if selector == "mixing":
        w = w.reshape(B, k, -1)
        nrm = torch.sqrt((w * w).sum(dim=2)) + 1e-12
        w = (w / nrm[:, :, None]).mean(dim=1)
        b = (b.reshape(B, k) / nrm).mean(dim=1)
    seps = [p for r in res for p in _parts(r.classifier)]
    assert len(seps) == w.shape[0]
    for (wr, br), wf, bf in zip(seps, w.double().numpy(), b.double().numpy()):
        np.testing.assert_array_equal(wr, wf)
        assert br == bf


def test_eps_override_vc_dim_and_c_match_reference():
    jinst, tinst = _both(_grid("sampling", k=3)[:3])
    opts = dict(eps=0.2, vc_dim=2, c=0.5, steps=500, stages=2, lam=1e-2)
    rj = jeng.oneway.run_instances(jinst, **opts)
    rt = toneway.run_instances(tinst, **opts, **CPU)
    for a, b in zip(rj, rt, strict=True):
        _assert_same(a, b)
        assert b.extra["sample_size"] == a.extra["sample_size"] == \
            tsamp.epsilon_net_size(0.2, 2, c=0.5)


def test_outcome_does_not_depend_on_batch_neighbours():
    small = teng.ProtocolInstance(
        datasets.data1(n_per_node=40, k=2, seed=3), 0.1, "sampling", 3)
    big = teng.ProtocolInstance(
        datasets.data3(n_per_node=90, k=2, seed=4), 0.02, "sampling", 4)
    alone = toneway.run_instances([small], **CPU)[0]
    padded = toneway.run_instances([small, big], **CPU)[0]
    assert alone.comm == padded.comm
    np.testing.assert_allclose(alone.classifier.w, padded.classifier.w,
                               rtol=1e-5)


def test_run_instances_refuses_mixed_or_two_way_buckets():
    shards = datasets.data1(n_per_node=20, k=2, seed=0)
    with pytest.raises(ValueError, match="share a selector"):
        toneway.run_instances([teng.ProtocolInstance(shards, 0.1, "naive"),
                               teng.ProtocolInstance(shards, 0.1, "voting")],
                              **CPU)
    with pytest.raises(ValueError, match="not a one-way selector"):
        toneway.run_instances([teng.ProtocolInstance(shards, 0.1)], **CPU)


# -- run_sweep: one-way mixed with the two-way selectors ----------------------

def test_run_sweep_mixed_one_way_and_two_way_in_input_order():
    s2 = datasets.data1(n_per_node=40, k=2, seed=0)
    s3 = datasets.data3(n_per_node=40, k=2, seed=1)
    s4 = datasets.data_mixed_hardness(n_per_node=30, k=4, seed=2)
    args = [(s2, 0.05, "naive"), (s2, 0.05, "median"),
            (s3, 0.1, "sampling", 7), (s2, 0.05, "maxmarg"),
            (s3, 0.05, "voting"), (s4, 0.05, "sampling", 9),
            (s3, 0.05, "mixing"), (s3, 0.1, "median")]
    jinst, tinst = _both(args)
    opts = dict(max_epochs=8, n_angles=128, steps=800)
    rj = jeng.run_sweep(jinst, **opts)
    rt = teng.run_sweep(tinst, **opts, **CPU)
    sels = [r.extra.get("selector", "median") if r.extra else "median"
            for r in rt]
    assert sels == [a[2] for a in args]
    for i, (a, b) in enumerate(zip(rj, rt, strict=True)):
        assert b.comm == a.comm, (i, a.comm, b.comm)
        assert (b.rounds, b.converged) == (a.rounds, a.converged), i
        if args[i][2] not in ("median", "maxmarg"):
            _assert_same(a, b)
    with pytest.raises(TypeError, match="cut_kernel"):
        teng.run_sweep(tinst[:1], cut_kernel=True, **CPU)   # no MEDIAN here


# -- the B=1 public APIs ------------------------------------------------------

def _apis(shards):
    """(JAX call, port call) of every one-way entry point at B=1."""
    return [
        (lambda: jone.random_sampling(shards, eps=0.1, seed=5),
         lambda: tone.random_sampling(shards, eps=0.1, seed=5, **CPU)),
        (lambda: jone.local_only(shards),
         lambda: tone.local_only(shards, **CPU)),
        (lambda: jbase.naive(shards), lambda: tbase.naive(shards, **CPU)),
        (lambda: jbase.voting(shards), lambda: tbase.voting(shards, **CPU)),
        (lambda: jbase.random(shards, eps=0.1, seed=2),
         lambda: tbase.random(shards, eps=0.1, seed=2, **CPU)),
        (lambda: jbase.mixing(shards), lambda: tbase.mixing(shards, **CPU)),
    ]


@pytest.mark.parametrize("k", [2, 3])
def test_b1_public_apis_match_reference(k):
    shards = datasets.data2(n_per_node=40, k=k, seed=k)
    for jcall, tcall in _apis(shards):
        rj, rt = jcall(), tcall()
        _assert_same(rj, rt)
        assert rt.comm["rounds"] == rt.rounds
        if rj.extra and "sample_size" in rj.extra:
            assert rt.extra["sample_size"] == rj.extra["sample_size"]


@pytest.mark.parametrize("k", [2, 3])
def test_host_protocols_match_reference(k):
    cases = [
        (jone.threshold_protocol, tone.threshold_protocol,
         datasets.threshold_instance(n=90, k=k)),
        (jone.interval_protocol, tone.interval_protocol,
         datasets.interval_instance(n=90, k=k)),
        (jone.rectangle_protocol, tone.rectangle_protocol,
         datasets.rectangle_instance(n=90, k=k)),
    ]
    for jfn, tfn, shards in cases:
        rj, rt = jfn(shards), tfn(shards)
        assert (rt.comm, rt.rounds, rt.converged) == \
            (rj.comm, rj.rounds, rj.converged)
        assert type(rt.classifier).__name__ == type(rj.classifier).__name__
        for f in rj.classifier.__dataclass_fields__:
            np.testing.assert_array_equal(getattr(rt.classifier, f),
                                          getattr(rj.classifier, f), f)
        assert rt.error_on(*shards[0]) == 0.0


def test_rectangle_without_positives_is_the_empty_box():
    rng = np.random.default_rng(0)
    shards = [(rng.uniform(-1, 1, size=(20, 3)), -np.ones(20, np.int32))
              for _ in range(3)]
    r = tone.rectangle_protocol(shards)
    probe = rng.uniform(-5, 5, size=(64, 3))
    assert (r.classifier.predict(probe) == -1).all()
    assert r.comm == jone.rectangle_protocol(shards).comm


def test_custom_fit_runs_the_metered_host_chain():
    """A custom ``fit`` callable runs the host loops: the same metering as
    the engine and as the JAX package's host loops, the sample from numpy's
    generator in both packages."""
    shards = datasets.data1(n_per_node=40, k=3, seed=0)
    jfit = jclf.fit_max_margin
    tfit = lambda X, y: tclf.fit_max_margin(X, y, device="cpu")  # noqa: E731
    pairs = [
        (jone.random_sampling(shards, eps=0.1, seed=4, fit=jfit),
         tone.random_sampling(shards, eps=0.1, seed=4, fit=tfit),
         tone.random_sampling(shards, eps=0.1, seed=4, **CPU)),
        (jbase.naive(shards, fit=jfit), tbase.naive(shards, fit=tfit),
         tbase.naive(shards, **CPU)),
        (jbase.voting(shards, fit=jfit), tbase.voting(shards, fit=tfit),
         tbase.voting(shards, **CPU)),
        (jbase.mixing(shards, fit=jfit), tbase.mixing(shards, fit=tfit),
         tbase.mixing(shards, **CPU)),
        (jone.local_only(shards, fit=jfit), tone.local_only(shards, fit=tfit),
         tone.local_only(shards, **CPU)),
    ]
    for rj, rt, r_eng in pairs:
        assert not (rt.extra or {}).get("engine")
        _assert_same(rj, rt)
        assert rt.comm == r_eng.comm and rt.rounds == r_eng.rounds
