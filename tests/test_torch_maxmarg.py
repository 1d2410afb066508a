"""The port's MAXMARG engine (``repro_torch.engine.maxmarg``) held against
the JAX reference (``repro.engine.maxmarg``) on the CPU.

Inputs are seeded numpy shards; the JAX package's packed state is carried
across with ``from_reference`` wherever one step is compared.

Tolerances:

* integer leaves and outputs (transcript labels and fills, turn, done,
  converged, epochs, carry and warm flags, latch counters, every comm
  counter, rounds): exact;
* the transcript points ``wx``: bit for bit (appends copy data rows);
* the separators (``h_w``/``h_b``, the per-node carries, the results):
  within 1e-4 of the instance's largest coordinate per step, and a cosine
  above 1 - 1e-4 between canonical directions over a sweep — the tier the
  JAX package holds between its own two solver paths
  (tests/test_maxmarg_warm.py).  The solvers are float approximations of
  the same optimum (tests/test_torch_solver.py says why).

``steps`` is 400 on both sides, except the reference's 2000 where a k=4
carry must latch and in the B=1 delegations, which fix it.
"""

import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax.numpy as jnp

from repro import engine as jeng
from repro.core import classifiers as jclf, datasets
from repro.core.protocols import kparty as jkparty, two_way as jtwo_way
from repro.engine import hotloop as jhot, maxmarg as jmm
from repro.kernels import ref as jref

import torch

from repro_torch import engine as teng
from repro_torch.core.protocols import kparty as tkparty, two_way as ttwo_way
from repro_torch.engine import hotloop as thot, maxmarg as tmm
from repro_torch.kernels import maxmarg_turn_scan_plain

STEPS = 400
MAX_EPOCHS = 24
COS = 1e-4
REL = 1e-4


def _grid():
    """tests/test_maxmarg_warm.py's grid: data1/2/3 × ε × seeds, k=2."""
    return [jeng.ProtocolInstance(gen(n_per_node=100, k=2, seed=seed), eps,
                                  "maxmarg")
            for gen in (datasets.data1, datasets.data2, datasets.data3)
            for eps in (0.05, 0.02) for seed in (0, 1)]


def _port(insts):
    return [teng.ProtocolInstance(i.shards, i.eps, i.selector)
            for i in insts]


def _canon(h):
    v = np.concatenate([h.w, [h.b]])
    return v / (np.linalg.norm(v) + 1e-30)


def _assert_decisions(rj, rt, cos=True):
    assert len(rj) == len(rt)
    for i, (a, b) in enumerate(zip(rj, rt)):
        assert a.comm == b.comm, (i, a.comm, b.comm)
        assert (a.rounds, a.converged) == (b.rounds, b.converged), i
        if cos:
            assert float(_canon(a.classifier) @ _canon(b.classifier)) \
                > 1.0 - COS, i


# -- (a) the turn scan on live engine states ---------------------------------

def test_turn_scan_plain_matches_jnp_twin_on_engine_grid():
    """tests/test_kernels.py's engine grid: mid-protocol transcripts, live
    separators, padded shards — every turn of a short sweep."""
    insts = [jeng.ProtocolInstance(
        datasets.data3(n_per_node=60, k=2, seed=s), 0.02, "maxmarg")
        for s in range(4)]
    data, state, k, _ = jeng.pack_instances_maxmarg(insts, max_epochs=8,
                                                    max_support=4)
    for _ in range(3):
        ci = int(np.asarray(state.turn)[0]) % k
        K = jnp.concatenate([data.X[:, ci], jnp.asarray(state.wx)[:, ci]], 1)
        yK = jnp.concatenate([data.y[:, ci], jnp.asarray(state.wy)[:, ci]], 1)
        w, b, _ = jclf._svm_solve_batch(K, yK.astype(K.dtype),
                                        jnp.float32(1e-3), 500, 2)
        args = [np.array(a) for a in (w, b, K, yK, data.X, data.y)]
        want = jref.maxmarg_turn_batch_ref(*args)
        got = maxmarg_turn_scan_plain(*map(torch.from_numpy, args))
        for g, e in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(e))
        state = jmm._step_jit(data, state, k=k, max_support=4, steps=500,
                              stages=2, lam0=1e-3, trans_width=None,
                              warm=False, fused_kernel=False)
        if bool(jnp.all(state.done)):
            break


# -- (b) packing and one step from a carried state --------------------------

INT_LEAVES = ("wy", "w_fill", "turn", "done", "converged", "epochs",
              "h_valid", "warm_turn", "c_valid", "warm_node", "latches")
FLOAT_LEAVES = ("h_w", "h_b", "c_w", "c_b")


def _assert_state(js, ts, what=""):
    for f in INT_LEAVES + ("wx",):
        np.testing.assert_array_equal(getattr(ts, f).numpy(),
                                      np.asarray(getattr(js, f)),
                                      err_msg=f"{what} {f}")
    for f in js.comm._fields:
        np.testing.assert_array_equal(getattr(ts.comm, f).numpy(),
                                      np.asarray(getattr(js.comm, f)),
                                      err_msg=f"{what} comm.{f}")
    for f in FLOAT_LEAVES:
        a = np.asarray(getattr(js, f))
        b = getattr(ts, f).numpy()
        scale = np.abs(a).reshape(a.shape[0], -1).max(axis=1)
        err = np.abs(a - b).reshape(a.shape[0], -1).max(axis=1)
        assert (err <= REL * scale).all(), (what, f, err, scale)


def test_pack_and_carry_every_leaf_equal():
    insts = _grid()[:5] + [jeng.ProtocolInstance(
        [(s[0][:70], s[1][:70]) for s in _grid()[5].shards], 0.05,
        "maxmarg")]                                     # ragged shard sizes
    jd, js, k, cap = jeng.pack_instances_maxmarg(insts, max_epochs=6,
                                                 max_support=3)
    td, ts, tk, tcap = teng.pack_instances_maxmarg(
        _port(insts), max_epochs=6, max_support=3, device="cpu")
    assert (tk, tcap) == (k, cap) == (2, jeng.maxmarg_transcript_capacity(
        2, 6, 3)) and cap == teng.maxmarg_transcript_capacity(2, 6, 3)
    for a, b in zip(jd, td):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    cd, cs, V = teng.from_reference(jd, js, device="cpu")
    assert V is None and type(cs) is teng.MaxMargState
    for f in teng.MaxMargState._fields:
        if f != "comm":
            assert torch.equal(getattr(cs, f), getattr(ts, f)), f
            np.testing.assert_array_equal(getattr(cs, f).numpy(),
                                          np.asarray(getattr(js, f)))
    with pytest.raises(ValueError, match="direction grid"):
        teng.from_reference(jd, js, np.zeros((4, 2)), device="cpu")
    with pytest.raises(ValueError, match="max_support"):
        teng.maxmarg_transcript_capacity(2, 6, 9)


@pytest.mark.parametrize("k,warm,per_node,width", [
    (2, False, False, None), (2, True, False, "fill"),
    (4, True, True, "fill"), (4, False, True, None)],
    ids=["k2-cold", "k2-warm", "k4-per-node", "k4-cold"])
def test_step_matches_reference_from_carried_state(k, warm, per_node, width):
    """Every turn of a sweep, the port steps from the JAX state carried
    across: integer leaves and transcript points exact, separators and
    carries to the stated tier."""
    if k == 2:
        insts = _grid()[::2]
    else:
        insts = [jeng.ProtocolInstance(
            datasets.data_mixed_hardness(n_per_node=60, k=4, seed=s), eps,
            "maxmarg") for s in (0, 1) for eps in (0.05, 0.02)]
    jd, js, k, cap = jeng.pack_instances_maxmarg(insts, max_epochs=4,
                                                 max_support=4)
    opts = dict(k=k, max_support=4, steps=STEPS, stages=3, lam0=1e-3,
                warm=warm, per_node=per_node, fused_kernel=False)
    for t in range(3 * k):
        if bool(np.asarray(js.done).all()):
            break
        W = None
        if width:
            W = jhot.quantize_width(int(np.asarray(js.w_fill).max()), cap)
        td, ts, _ = teng.from_reference(jd, js, device="cpu")
        tnext = tmm.step(td, ts, trans_width=W, **opts)
        js = jmm._step_jit(jd, js, trans_width=W, **opts)
        _assert_state(js, tnext, f"turn {t}")
    assert t >= 1


def test_append_past_capacity_raises():
    """JAX's clamped write would overwrite live rows; the port asserts the
    capacity's slack instead."""
    B, k, cap, d, r = 2, 2, 8, 2, 4
    wx = torch.zeros((B, k, cap, d))
    wy = torch.zeros((B, k, cap), dtype=torch.int32)
    fill = torch.tensor([[0, 4], [5, 0]], dtype=torch.int32)
    pts = torch.ones((B, r, d))
    labs = torch.ones((B, r), dtype=torch.int32)
    tmm._append_block(wx, wy, fill, pts, labs, torch.ones(B, dtype=bool),
                      node=1)
    assert fill.tolist() == [[0, 8], [5, 4]]
    with pytest.raises(RuntimeError, match="capacity"):
        tmm._append_block(wx, wy, fill, pts, labs,
                          torch.zeros(B, dtype=bool), node=0)


def test_per_node_latch_where_single_carry_falls_through():
    """tests/test_maxmarg_warm.py's crafted mid-protocol state, carried
    across: the per-node polish latches, the single carry and the cold
    step do not, and every protocol decision is the same on all three —
    and the same as JAX's."""
    rng = np.random.default_rng(5)
    half = 30
    shards = []
    for cx in (-1.0, 0.0, 1.0):
        Xp = np.stack([rng.uniform(-2.0, -0.6, half),
                       rng.uniform(cx - 0.5, cx + 0.5, half)], 1)
        Xn = np.stack([rng.uniform(0.6, 2.0, half),
                       rng.uniform(cx - 0.5, cx + 0.5, half)], 1)
        shards.append((np.concatenate([Xp, Xn]).astype(np.float32),
                       np.concatenate([np.ones(half),
                                       -np.ones(half)]).astype(np.int32)))
    inst = [jeng.ProtocolInstance(shards, 0.05, "maxmarg")]
    jd, s0, k, _ = jeng.pack_instances_maxmarg(inst, max_epochs=8,
                                               max_support=4)
    wx, wy, fill = (np.array(a) for a in (s0.wx, s0.wy, s0.w_fill))
    wx[0, 0, 0], wy[0, 0, 0] = (-0.7, 0.3), 1
    wx[0, 0, 1], wy[0, 0, 1] = (0.7, -0.3), -1
    fill[0, 0] = 2
    base = s0._replace(
        wx=wx, wy=wy, w_fill=fill, turn=np.full((1,), 3, np.int32),
        h_w=np.array([[0.0, 1.0]], np.float32),
        h_b=np.zeros((1,), np.float32), h_valid=np.ones((1,), bool),
        warm_turn=np.ones((1,), bool),
        c_w=np.tile(np.array([[[-1.0, 0.0]]], np.float32), (1, 3, 1)),
        c_b=np.zeros((1, 3), np.float32), c_valid=np.ones((1, 3), bool),
        warm_node=np.ones((1, 3), bool))
    td, ts, _ = teng.from_reference(jd, base, device="cpu")
    opts = dict(k=k, max_support=4, steps=500, stages=2, lam0=1e-3)
    pn = tmm.step(td, ts, warm=True, per_node=True, **opts)
    sg = tmm.step(td, ts, warm=True, per_node=False, **opts)
    cold = tmm.step(td, ts, warm=False, per_node=True, **opts)
    assert [int(s.latches[0]) for s in (pn, sg, cold)] == [1, 0, 0]
    for other in (sg, cold):
        for a, b in zip(pn.comm, other.comm):
            assert torch.equal(a, b)
        for f in ("wy", "w_fill", "done", "converged"):
            assert torch.equal(getattr(pn, f), getattr(other, f)), f
    jpn = jmm._step_jit(jd, jeng.MaxMargState(*map(jnp.asarray, base[:-1]),
                                              base.comm),
                        warm=True, per_node=True, trans_width=None,
                        fused_kernel=False, **opts)
    _assert_state(jpn, pn, "crafted")


# -- (c) sweeps against the reference ----------------------------------------

@pytest.fixture(scope="module")
def grid_runs():
    insts = _grid()
    runs = {}
    for name, kw in (("hot", dict(warm=True, compact=True)),
                     ("cold", dict(warm=False, compact=False)),
                     ("compact", dict(warm=False, compact=True))):
        jhot.KEY_LOG.clear()
        rj = jeng.maxmarg.run_instances(insts, max_epochs=MAX_EPOCHS,
                                        steps=STEPS, **kw)
        jkeys = list(jhot.KEY_LOG)
        thot.KEY_LOG.clear()
        rt = tmm.run_instances(_port(insts), max_epochs=MAX_EPOCHS,
                               steps=STEPS, device="cpu", **kw)
        runs[name] = (rj, rt, jkeys, list(thot.KEY_LOG))
    return runs


@pytest.mark.parametrize("path", ["hot", "cold", "compact"])
def test_sweep_matches_reference(grid_runs, path):
    """Hot (warm + compacted), cold ``run_compiled`` and compaction alone:
    comm, rounds and convergence exact against the JAX package's run of
    the same path, and the hot loop's launch shapes equal to its compile
    keys."""
    rj, rt, jkeys, tkeys = grid_runs[path]
    _assert_decisions(rj, rt)
    assert all(r.converged for r in rt)
    assert tkeys == jkeys
    assert rt[0].extra == dict(rj[0].extra, device="cpu")


def test_warm_and_cold_decision_exact_on_the_port(grid_runs):
    """The port's own gate, as tests/test_maxmarg_warm.py's for JAX: warm
    and compacted refits change no decision against the cold model."""
    _assert_decisions(grid_runs["cold"][1], grid_runs["hot"][1])
    _assert_decisions(grid_runs["cold"][1], grid_runs["compact"][1])


def test_solver_paths_and_overlap_decision_exact_on_the_port(grid_runs):
    """The kernel solver path (plain version on the CPU) and the
    double-buffered loop make the classic hot path's decisions."""
    insts = _port(_grid()[:6])
    base = grid_runs["hot"][1][:6]
    kern = tmm.run_instances(insts, max_epochs=MAX_EPOCHS, steps=STEPS,
                             solver_kernel=True, fused_kernel=True,
                             device="cpu")
    over = tmm.run_instances(insts, max_epochs=MAX_EPOCHS, steps=STEPS,
                             overlap=True, device="cpu")
    _assert_decisions(base, kern)
    _assert_decisions(base, over)


@pytest.mark.parametrize("seed,eps,warm", [(0, 0.1, True), (1, 0.05, False)],
                         ids=["hot", "cold"])
def test_kparty_k4_matches_reference(seed, eps, warm):
    inst = [jeng.ProtocolInstance(datasets.data3(n_per_node=75, k=4,
                                                 seed=seed), eps, "maxmarg")]
    kw = dict(warm=warm, compact=warm)
    rj = jeng.maxmarg.run_instances(inst, max_epochs=MAX_EPOCHS, steps=STEPS,
                                    **kw)
    rt = tmm.run_instances(_port(inst), max_epochs=MAX_EPOCHS, steps=STEPS,
                           device="cpu", **kw)
    _assert_decisions(rj, rt)


def test_per_node_and_single_carry_at_k4():
    """The per-node carry latches in a multi-epoch k=4 sweep with the JAX
    package's decisions and latch count, and per-node, single-carry and
    cold runs make the same decisions, as tests/test_maxmarg_warm.py
    checks for JAX.  At the reference's 2000 steps: with fewer, warm and
    cold refits part ways on this grid in the JAX package too."""
    inst = [jeng.ProtocolInstance(datasets.data_mixed_hardness(seed=0),
                                  0.05, "maxmarg")]
    rj = jeng.maxmarg.run_instances(inst, max_epochs=6)
    out = {name: tmm.run_instances(_port(inst), max_epochs=6, device="cpu",
                                   **kw)[0]
           for name, kw in (("per_node", {}), ("single", dict(per_node=False)),
                            ("cold", dict(warm=False, compact=False)))}
    _assert_decisions(rj, [out["per_node"]])
    assert out["per_node"].extra["warm_latches"] == rj[0].extra["warm_latches"]
    assert out["per_node"].rounds >= 2 and out["per_node"].converged
    assert out["per_node"].extra["warm_latches"] >= 1
    assert out["per_node"].extra["warm_latches"] >= \
        out["single"].extra["warm_latches"]
    _assert_decisions([out["cold"]] * 2, [out["per_node"], out["single"]],
                      cos=False)


@pytest.mark.parametrize("solver_kernel", [False, True],
                         ids=["classic", "kernel"])
def test_highd_sweep_matches_reference(solver_kernel):
    """d=16 (tests/test_maxmarg_warm.py's high-d sweep) on both solver
    paths."""
    insts = [jeng.ProtocolInstance(
        datasets.data_highd(n_per_node=80, k=2, d=16, seed=s, margin=0.2),
        0.05, "maxmarg") for s in (0, 1)]
    rj = jeng.maxmarg.run_instances(insts, max_epochs=MAX_EPOCHS,
                                    steps=STEPS, solver_kernel=solver_kernel)
    rt = tmm.run_instances(_port(insts), max_epochs=MAX_EPOCHS, steps=STEPS,
                           solver_kernel=solver_kernel, device="cpu")
    _assert_decisions(rj, rt)
    assert all(r.converged for r in rt)
    assert rt[0].classifier.w.shape == (16,)


# -- (d) public API ----------------------------------------------------------

def test_run_sweep_mixed_selectors_in_input_order():
    """MEDIAN and MAXMARG instances interleaved: one bucket each, results
    in input order, each bucket given only its own options."""
    a = datasets.data1(n_per_node=60, k=2, seed=1)
    b = datasets.data3(n_per_node=50, k=2, seed=2)
    c = datasets.data_highd(n_per_node=40, k=2, d=5, seed=0, margin=0.2)
    insts = [jeng.ProtocolInstance(a, 0.05, "maxmarg"),
             jeng.ProtocolInstance(b, 0.05),
             jeng.ProtocolInstance(c, 0.05, "maxmarg"),
             jeng.ProtocolInstance(b, 0.05, "maxmarg"),
             jeng.ProtocolInstance(a, 0.1)]
    opts = dict(n_angles=128, max_epochs=6, steps=STEPS)
    rj = jeng.run_sweep(insts, **opts)
    rt = teng.run_sweep(_port(insts), device="cpu", **opts)
    _assert_decisions(rj, rt, cos=False)
    assert [r.extra["selector"] for r in rt] == \
        ["maxmarg", "median", "maxmarg", "maxmarg", "median"]
    assert rt[2].classifier.w.shape == (5,)
    for i in (0, 2, 3):
        assert float(_canon(rj[i].classifier) @ _canon(rt[i].classifier)) \
            > 1.0 - COS
    with pytest.raises(TypeError, match="n_angle"):
        teng.run_sweep(_port(insts[:1]), n_angle=8, device="cpu")
    # donation runs on one device as in JAX: every turn written into the
    # state's own tensors, the results bit for bit the copying run's
    mm = [_port(insts)[i] for i in (0, 3)]
    don = tmm.run_instances(mm, donate=True, max_epochs=6, steps=STEPS,
                            device="cpu")
    cop = tmm.run_instances(mm, max_epochs=6, steps=STEPS, device="cpu")
    for a, b in zip(don, cop):
        assert (a.comm, a.rounds, a.converged) == \
            (b.comm, b.rounds, b.converged)
        np.testing.assert_array_equal(a.classifier.w, b.classifier.w)
        assert a.classifier.b == b.classifier.b


def test_iterative_support_maxmarg_b1_delegation():
    shards = datasets.data2(n_per_node=80, k=2, seed=3)
    a = jtwo_way.iterative_support_maxmarg(shards, eps=0.05, max_rounds=16)
    b = ttwo_way.iterative_support_maxmarg(shards, eps=0.05, max_rounds=16,
                                           device="cpu")
    _assert_decisions([a], [b])
    assert b.extra["selector"] == "maxmarg" and b.extra["batch"] == 1


@pytest.mark.parametrize("d,selector", [(2, "maxmarg"), (4, "median")])
def test_kparty_routes_to_maxmarg(d, selector):
    """``selector="maxmarg"``, and any d != 2 whatever the selector, run
    the MAXMARG engine, as in the JAX package."""
    if d == 2:
        shards = datasets.data3(n_per_node=50, k=3, seed=1)
    else:
        shards = datasets.data_highd(n_per_node=50, k=3, d=d, seed=1,
                                     margin=0.2)
    a = jkparty.iterative_support_kparty(shards, eps=0.05, max_epochs=4,
                                         selector=selector)
    b = tkparty.iterative_support_kparty(shards, eps=0.05, max_epochs=4,
                                         selector=selector, device="cpu")
    _assert_decisions([a], [b])
    assert b.extra["selector"] == "maxmarg"
