"""The port's MEDIAN engine (``repro_torch.engine``) held against the JAX
reference (``repro.engine``) on the CPU.

Inputs are seeded numpy shards; the JAX package's packed state and
direction grid are carried across with ``from_reference`` wherever two
paths are compared bit for bit.

The reference arithmetic is JAX's inline step compiled with XLA's fusion
pass off.  With fusion on, XLA:CPU contracts the fused append-time
projection ``v0*x0 + v1*x1`` into ``fma(v0, x0, v1*x1)``, so the jitted
step and the same step run op by op differ by 1 ulp on ``lo_w``/``hi_w``
(ROADMAP Queue 3).  The port rounds after every operation, on the CPU and
in its CUDA kernels, so it is held bitwise to the unfused step, and at the
decision tier to the fused engine as users run it (the public-API tests).

Tolerances: integer leaves and outputs exact everywhere; float leaves
bitwise against the unfused reference (``np.array_equal``, which counts
+0 == -0); 1e-5 on separators in the public-API tests, where each package
runs its own engine on its own grid (the grids differ by 1 ulp on a few
entries).
"""

import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

from repro import engine as jeng
from repro.core import datasets, geometry as jgeo
from repro.core.protocols import kparty as jkparty, two_way as jtwo_way
from repro.engine import hotloop as jhot, median as jmed

import torch

from repro_torch import engine as teng
from repro_torch.core.protocols import kparty as tkparty, two_way as ttwo_way
from repro_torch.engine import hotloop as thot, median as tmed
from repro_torch.kernels import median_cut_scores_plain, median_extremes_plain

N_ANGLES = 128
MAX_EPOCHS = 6
UNFUSED = {"xla_disable_hlo_passes": "fusion"}


def _grid(B=8, n_per_node=40, noisy_every=4):
    """MEDIAN grid with a noisy tail: every ``noisy_every``-th instance gets
    10% label noise and ε=0.02 (mistake budget 1) and runs to the turn
    budget on the compacted hot path (benchmarks/engine_sweep.py recipe)."""
    gens = (datasets.data1, datasets.data2, datasets.data3)
    out = []
    for i in range(B):
        shards = gens[i % 3](n_per_node=n_per_node, k=2, seed=i)
        eps = (0.1, 0.05)[i % 2]
        if i % noisy_every == 0:
            shards = datasets.add_label_noise(shards, 0.1, seed=i)
            eps = 0.02
        out.append(jeng.ProtocolInstance(shards, eps))
    return out


class _Unfused:
    """JAX's own ``step`` / ``run_compiled``, compiled per static variant
    with XLA's fusion pass off."""

    def __init__(self):
        self.cache = {}

    def _get(self, key, fn, statics, args, kw):
        if key not in self.cache:
            self.cache[key] = jax.jit(fn, static_argnames=statics).lower(
                *args, **kw).compile(compiler_options=UNFUSED)
        return self.cache[key]

    def step(self, data, V, s, **kw):
        key = ("step", tuple(np.shape(s.wx)), tuple(sorted(kw.items())))
        return self._get(key, jmed.step, jmed._STEP_STATICS,
                         (data, V, s), kw)(data, V, s)

    def call(self, fn, *args, **kw):
        """Any JAX function of arrays, compiled unfused once per function."""
        key = ("call", fn, tuple(np.shape(a) for a in args))
        return self._get(key, fn, tuple(kw), args, kw)(*args)

    def run_compiled(self, data, V, s, *, k, max_turns):
        """``repro.engine.median.run_compiled`` (the cold model, bit-exact
        against JAX's hot path), compiled unfused."""
        kw = dict(k=k, max_turns=max_turns)
        return self._get(("cold", k, max_turns), jmed.run_compiled.__wrapped__,
                         tuple(kw), (data, V, s), kw)(data, V, s)


@pytest.fixture(scope="module")
def ref():
    insts = _grid()
    data, state0, k, cap = jeng.pack_instances(
        insts, n_angles=N_ANGLES, max_epochs=MAX_EPOCHS)
    V = jgeo.direction_grid(N_ANGLES)
    return dict(insts=insts, data=data, state0=state0, k=k, cap=cap, V=V,
                unfused=_Unfused())


def _leaf_diffs(jstate, tstate):
    """Names of the leaves (comm fields by name) that differ."""
    bad = []
    for f in jstate._fields:
        a, b = getattr(jstate, f), getattr(tstate, f)
        if f == "comm":
            bad += [g for g in a._fields if not np.array_equal(
                np.asarray(getattr(a, g)), getattr(b, g).numpy())]
        elif not np.array_equal(np.asarray(a), b.numpy()):
            bad.append(f)
    return bad


def _carry(ref, state):
    return teng.from_reference(ref["data"], state, ref["V"], device="cpu")


# -- (c) plain versions against JAX's inline scans on live engine states ----

def _jax_inline_scores(V, dir_ok, lo, hi, Xc, yc):
    """``repro.engine.median.step``'s inline cut scan (stage 2), verbatim."""
    import jax.numpy as jnp
    B, m = dir_ok.shape
    projc = jmed._proj_grid(V, Xc)
    nonempty = (lo < hi) & dir_ok
    lo_r = jnp.where(nonempty, lo, jnp.inf)
    hi_r = jnp.where(nonempty, hi, -jnp.inf)
    risk = jnp.where((yc == 1)[:, None, :],
                     projc > lo_r[:, :, None], projc < hi_r[:, :, None])
    idx = jnp.arange(m)[None, :, None]
    last = jnp.max(jnp.where(risk, idx, -1), axis=1)
    first = jnp.min(jnp.where(risk, idx, m), axis=1)
    rows = jnp.arange(B)[:, None]
    livei = ((last >= 0) & (yc != 0)).astype(jnp.int32)
    hist_last = (jnp.zeros((B, m), jnp.int32)
                 .at[rows, jnp.clip(last, 0, m - 1)].add(livei))
    hist_first = (jnp.zeros((B, m), jnp.int32)
                  .at[rows, jnp.clip(first, 0, m - 1)].add(livei))
    below = jnp.cumsum(hist_last, axis=1)
    above = (jnp.sum(livei, axis=1)[:, None]
             - jnp.cumsum(hist_first, axis=1))
    return jnp.where(dir_ok, jnp.minimum(below, above), -1)


def _jax_inline_extremes(v, XW, yW):
    """Row choices of ``repro.engine.median._extremes`` (stage 5)."""
    import jax.numpy as jnp
    pj = jmed._proj_dir(XW, v)
    return (jnp.argmax(jnp.where(yW == 1, pj, -jnp.inf), axis=2),
            jnp.argmin(jnp.where(yW == -1, pj, jnp.inf), axis=2))


def test_plain_scans_match_jax_inline_on_live_states(ref):
    """Integer-exact, first-index ties included: the coordinator's bounds
    are built from shipped points, so projections sit on the strict risk
    edges; the whole turn sequence is checked."""
    import jax.numpy as jnp
    k, V = ref["k"], ref["V"]
    js = ref["state0"]
    Vt = torch.from_numpy(np.array(V))
    for t in range(2 * MAX_EPOCHS):
        ci = np.asarray(js.turn) % k
        rows = np.arange(len(ci))
        X = np.asarray(ref["data"].X)
        y = np.asarray(ref["data"].y)
        args = (np.array(js.dir_ok), np.asarray(js.lo_w)[rows, ci],
                np.asarray(js.hi_w)[rows, ci], X[rows, ci], y[rows, ci])
        want = np.asarray(ref["unfused"].call(_jax_inline_scores, V, *args))
        got = median_cut_scores_plain(Vt, *map(torch.from_numpy, args))
        np.testing.assert_array_equal(got.numpy(), want, err_msg=f"turn {t}")

        v = np.asarray(V)[np.full(len(ci), (37 * t) % N_ANGLES)]
        XW = np.concatenate([X, np.asarray(js.wx)], axis=2)
        yW = np.concatenate([y, np.asarray(js.wy)], axis=2)
        want_p, want_q = ref["unfused"].call(_jax_inline_extremes, v, XW, yW)
        i_p, i_q = median_extremes_plain(torch.from_numpy(np.asarray(v)),
                                         torch.from_numpy(XW),
                                         torch.from_numpy(yW))
        np.testing.assert_array_equal(i_p.numpy(), np.asarray(want_p))
        np.testing.assert_array_equal(i_q.numpy(), np.asarray(want_q))
        js = ref["unfused"].step(ref["data"], V, js, k=k,
                                 first_turn=(t == 0))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_plain_scans_match_jax_inline_on_crafted_ties(ref, seed):
    """chip_smoke.py's crafted tie inputs (duplicate points, bounds built by
    the port's ``_append2`` from the scanned points, an absent class, no
    allowed direction), integer-exact against JAX's inline scans."""
    import chip_smoke
    Vt = torch.from_numpy(np.array(ref["V"]))
    cut = chip_smoke.crafted_cut_inputs(Vt, "cpu", seed)
    want = ref["unfused"].call(_jax_inline_scores,
                               *(a.numpy() for a in cut))
    got = median_cut_scores_plain(*cut)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (got[4] == -1).all()
    ext = chip_smoke.crafted_extremes_inputs("cpu", seed)
    want_p, want_q = ref["unfused"].call(_jax_inline_extremes,
                                         *(a.numpy() for a in ext))
    i_p, i_q = median_extremes_plain(*ext)
    np.testing.assert_array_equal(i_p.numpy(), np.asarray(want_p))
    np.testing.assert_array_equal(i_q.numpy(), np.asarray(want_q))


# -- (d) step by step, state and grid carried across ------------------------

@pytest.mark.parametrize("kernels", [False, True], ids=["inline", "kernels"])
def test_step_matches_reference_every_leaf_every_turn(ref, kernels):
    """Kernels on takes the plain versions on the CPU; every leaf, floats
    bitwise, after every turn, including the first-turn constant fold."""
    k, V = ref["k"], ref["V"]
    data_t, ts, Vt = _carry(ref, ref["state0"])
    js = ref["state0"]
    for t in range(2 * MAX_EPOCHS):
        js = ref["unfused"].step(ref["data"], V, js, k=k,
                                 first_turn=(t == 0))
        ts = tmed.step(data_t, Vt, ts, k=k, first_turn=(t == 0),
                       cut_kernel=kernels, extremes_kernel=kernels)
        assert _leaf_diffs(js, ts) == [], f"turn {t}"
    assert not np.asarray(js.done).all()      # the noisy tail ran to the end


def test_step_fill_capped_read_is_bit_exact(ref):
    """A ``trans_width`` covering the live fill changes no bit."""
    k = ref["k"]
    data_t, ts, Vt = _carry(ref, ref["state0"])
    full = capped = ts
    for t in range(6):
        w = thot.quantize_width(int(capped.w_fill.max()) + tmed.WIDTH_SLACK,
                                ref["cap"])
        full = tmed.step(data_t, Vt, full, k=k, first_turn=(t == 0))
        capped = tmed.step(data_t, Vt, capped, k=k, first_turn=(t == 0),
                           trans_width=w)
        for f in full._fields:
            if f != "comm":
                assert torch.equal(getattr(full, f), getattr(capped, f)), f


def _concatenated_stage5(data, wx, wy, v):
    """Stage 5 as the step spelled it before it read the segments where
    they lie: one concatenation, the one-segment scan, gathers, projections."""
    from repro_torch.core.geometry import project_each
    XW = torch.cat([data.X, wx], dim=2)
    yW = torch.cat([data.y, wy], dim=2)
    i_p, i_q = median_extremes_plain(v, XW, yW)
    has_p, has_q = (yW == 1).any(dim=2), (yW == -1).any(dim=2)
    rows = (torch.arange(XW.shape[0])[:, None],
            torch.arange(XW.shape[1])[None, :])
    p, q = XW[rows + (i_p.long(),)], XW[rows + (i_q.long(),)]
    return (p, q, has_p, has_q,
            torch.where(has_p, project_each(p, v), -np.inf),
            torch.where(has_q, project_each(q, v), np.inf))


@pytest.mark.parametrize("capped", [False, True], ids=["full", "capped"])
def test_node_extremes_equals_the_concatenated_stage(ref, capped):
    """On the live states of the port's walk, stage 5 over the two
    segments gives, bit for bit, what it gave over their concatenation."""
    k = ref["k"]
    data_t, ts, Vt = _carry(ref, ref["state0"])
    for t in range(2 * MAX_EPOCHS):
        v = Vt[torch.full((ts.wx.shape[0],), (29 * t + 3) % N_ANGLES)]
        w = (thot.quantize_width(int(ts.w_fill.max()) + tmed.WIDTH_SLACK,
                                 ref["cap"]) if capped else None)
        got = tmed.node_extremes(data_t, ts.wx, ts.wy, v, w, kernel=True)
        cut = slice(None) if w is None else slice(0, w)
        want = _concatenated_stage5(data_t, ts.wx[:, :, cut],
                                    ts.wy[:, :, cut], v)
        for name, g, e in zip(("p", "q", "has_p", "has_q", "lo", "hi"),
                              got, want):
            assert torch.equal(g, e), f"turn {t}: {name}"
        ts = tmed.step(data_t, Vt, ts, k=k, first_turn=(t == 0),
                       trans_width=w)


# -- (e) the hot sweep ------------------------------------------------------

OUTPUT_LEAVES = ("done", "converged", "epochs", "h_v", "h_t", "h_valid",
                 "dir_ok")


def _assert_outputs_equal(jstate, tstate):
    """Every output a sweep reports (and the direction arc), bit for bit;
    ``turn`` and the scratch rows differ between hot and cold by design."""
    for f in OUTPUT_LEAVES:
        np.testing.assert_array_equal(getattr(tstate, f).numpy(),
                                      np.asarray(getattr(jstate, f)), f)
    for f in tstate.comm._fields:
        np.testing.assert_array_equal(getattr(tstate.comm, f).numpy(),
                                      np.asarray(getattr(jstate.comm, f)), f)


@pytest.fixture(scope="module")
def port_hot(ref):
    data_t, s0, Vt = _carry(ref, ref["state0"])
    final = tmed.run_hot(data_t, Vt, s0, k=ref["k"],
                         max_turns=ref["k"] * MAX_EPOCHS)
    return final, s0


def test_hot_sweep_bitwise_against_reference(ref, port_hot):
    """Port hot against JAX's cold model (which JAX holds bit-exact to its
    hot path), the noisy tail included."""
    k = ref["k"]
    jcold = ref["unfused"].run_compiled(ref["data"], ref["V"], ref["state0"],
                                        k=k, max_turns=k * MAX_EPOCHS)
    _assert_outputs_equal(jcold, port_hot[0])
    assert not port_hot[0].done.all()        # the noisy tail ran to the end


def test_hot_sweep_does_not_touch_callers_state(port_hot):
    s0 = port_hot[1]
    assert int(s0.turn.max()) == 0 and int(s0.w_fill.max()) == 0


@pytest.mark.parametrize("overlap", [False, True], ids=["plain", "overlap"])
def test_hot_equals_cold(ref, overlap):
    """Port hot (and double-buffered hot) against port cold, bit for bit."""
    k = ref["k"]
    data_t, s0, Vt = _carry(ref, ref["state0"])
    cold = tmed.run_compiled(data_t, Vt, s0, k=k, max_turns=k * MAX_EPOCHS)
    hot = tmed.run_hot(data_t, Vt, s0, k=k, max_turns=k * MAX_EPOCHS,
                       overlap=overlap)
    for f in OUTPUT_LEAVES:
        assert torch.equal(getattr(hot, f), getattr(cold, f)), f
    for f in hot.comm._fields:
        assert torch.equal(getattr(hot.comm, f), getattr(cold.comm, f)), f


# -- (f) public API, each package on its own grid ---------------------------

def _assert_results_agree(rj, rt, atol=1e-5):
    assert len(rj) == len(rt)
    for i, (a, b) in enumerate(zip(rj, rt)):
        assert a.comm == b.comm, i
        assert (a.rounds, a.converged) == (b.rounds, b.converged), i
        np.testing.assert_allclose(b.classifier.w, a.classifier.w,
                                   rtol=0, atol=atol)
        assert abs(b.classifier.b - a.classifier.b) <= atol, i


def test_run_sweep_public_api_own_grids_and_launch_shapes():
    """The fused JAX engine as users run it against the port: integer
    outputs exact, separators to 1e-5, and the hot loop's launch shapes
    (``KEY_LOG``) equal to the JAX loop's compile keys for the same sweep."""
    insts = _grid(B=8, n_per_node=60, noisy_every=4)
    jhot.KEY_LOG.clear()
    rj = jeng.run_sweep(insts, n_angles=256, max_epochs=4)
    jkeys = list(jhot.KEY_LOG)
    thot.KEY_LOG.clear()
    rt = teng.run_sweep([teng.ProtocolInstance(i.shards, i.eps)
                         for i in insts], n_angles=256, max_epochs=4,
                        device="cpu")
    _assert_results_agree(rj, rt)
    assert list(thot.KEY_LOG) == jkeys
    assert any(n_pad < len(insts) for n_pad, *_ in jkeys)   # compacted tail
    assert rt[0].extra["device"] == "cpu" and rt[0].extra["compact"]


def test_iterative_support_median_b1_delegation():
    shards = datasets.data3(n_per_node=80, k=2, seed=3)
    a = jtwo_way.iterative_support_median(shards, eps=0.05, max_rounds=16,
                                          n_angles=256)
    b = ttwo_way.iterative_support_median(shards, eps=0.05, max_rounds=16,
                                          n_angles=256, device="cpu")
    _assert_results_agree([a], [b])


def test_kparty_three_nodes():
    shards = datasets.data3(n_per_node=50, k=3, seed=1)
    a = jkparty.iterative_support_kparty(shards, eps=0.05, max_epochs=4,
                                         n_angles=128)
    b = tkparty.iterative_support_kparty(shards, eps=0.05, max_epochs=4,
                                         n_angles=128, device="cpu")
    _assert_results_agree([a], [b])


def test_run_sweep_refuses_what_is_not_ported():
    """The options each selector takes are the JAX package's ``_ALLOWED``
    table: ``stats`` on a VOTING-only sweep is a ``TypeError`` in both
    packages (no selector of that sweep takes it), while ``mesh=None`` on
    MEDIAN and ``stats`` on MAXMARG run (single-device: the dict stays
    empty); a typo'd option raises ``TypeError``, an unknown selector
    ``ValueError``.  ``unified_dispatch=True`` runs."""
    inst = teng.ProtocolInstance(datasets.data1(n_per_node=20, k=2), 0.1)
    voting = teng.ProtocolInstance(inst.shards, 0.1, "voting")
    with pytest.raises(TypeError, match="stats"):
        teng.run_sweep([voting], stats={}, device="cpu")
    with pytest.raises(TypeError, match="stats"):
        jeng.run_sweep([jeng.ProtocolInstance(inst.shards, 0.1, "voting")],
                       stats={})
    with pytest.raises(TypeError, match="n_angles"):
        teng.run_sweep([voting], n_angles=8, device="cpu")  # MEDIAN's
    res = teng.run_sweep([inst], unified_dispatch=True, n_angles=64,
                         max_epochs=4, device="cpu")
    assert res[0].extra["unified"] and res[0].extra["selector"] == "median"
    plain = teng.run_sweep([inst], n_angles=64, max_epochs=4, device="cpu")
    res = teng.run_sweep([inst], mesh=None, n_angles=64, max_epochs=4,
                         device="cpu")
    assert res[0].comm == plain[0].comm and "devices" not in res[0].extra
    stats = {}
    res = teng.run_sweep([teng.ProtocolInstance(inst.shards, 0.1, "maxmarg")],
                         stats=stats, max_epochs=4, steps=200, device="cpu")
    assert res[0].converged and stats == {}
    with pytest.raises(TypeError, match="max_epoch"):
        teng.run_sweep([inst], max_epoch=4, device="cpu")
    with pytest.raises(TypeError, match="steps"):
        teng.run_sweep([inst], steps=4, device="cpu")   # MAXMARG's option
    with pytest.raises(ValueError, match="unknown selector"):
        teng.run_sweep([teng.ProtocolInstance(inst.shards, 0.1, "bogus")],
                       device="cpu")
