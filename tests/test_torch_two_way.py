"""The port's two-way host protocols and geometry held against the JAX
reference on the CPU: the numpy hull geometry, the device range scans
(``consistent_threshold_ranges`` / ``uncertain_mask``), the single-instance
Pegasos solver ``_svm_solve``, §5's MEDIAN with rotation-bit replies
(``iterative_support_median_bit``) and §8.2's noisy MAXMARG
(``iterative_support_noisy``).

Tolerances:

* hull indices, the nearest-edge charge and the weighted median index
  equal; edges and normals to 1e-12 (the same numpy code on both sides);
* ranges to one f32 ulp of the transcript's largest row norm (±inf
  exact): JAX's ``V @ Xw.T`` may contract a product into an FMA, the port
  rounds each operation; set-of-uncertainty and risk-matrix booleans exact
  where no point of the scanned set is in the transcript;
* ``_svm_solve``: 1e-3 of the separator's scale (max |w_i|, |b|) — the
  port's stage sums the hinge gradient in its kernel's order, XLA in its
  own, over 3000 steps;
* the protocols: comm, rounds, convergence and ``best_err`` exact;
  separators to 1e-6 (bit protocol: both pick their direction from the
  same carried f32 grid) and to 1e-3 of scale (noisy protocol: its fits).
  The bit protocol's full-budget noisy runs are held to the self-tie tier
  of ``test_median_bit_noisy_runs_equal_jax_up_to_self_ties``.
"""

import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax.numpy as jnp

from repro.core import classifiers as jclf, datasets, geometry as jgeo
from repro.core.comm import make_nodes as jmake_nodes
from repro.core.protocols import two_way as jtw

import torch

from repro_torch.core import classifiers as tclf, geometry as tgeo
from repro_torch.core.comm import make_nodes as tmake_nodes
from repro_torch.core.protocols import two_way as ttw


# -- (a) hull geometry ---------------------------------------------------------

def _points(n, seed, kind):
    rng = np.random.default_rng(seed)
    if kind == "collinear":
        t = rng.normal(size=n)
        return np.stack([t, 2.0 * t + 1.0], axis=1)
    if kind == "duplicates":
        base = rng.normal(size=(max(1, n // 3), 2))
        return base[rng.integers(0, len(base), size=n)]
    return rng.normal(size=(n, 2)) * np.array([1.5, 0.7])


@pytest.mark.parametrize("kind", ["gaussian", "collinear", "duplicates"])
@pytest.mark.parametrize("n", [0, 1, 2, 3, 17, 200])
def test_hull_geometry_equals_jax(n, kind):
    P = _points(n, seed=n + len(kind), kind=kind)
    hj, ht = jgeo.convex_hull_2d(P), tgeo.convex_hull_2d(P)
    np.testing.assert_array_equal(ht, hj)
    assert ht.dtype == hj.dtype
    if n == 0:
        return
    ej, et = jgeo.hull_edges(P, hj), tgeo.hull_edges(P, ht)
    np.testing.assert_allclose(et, ej, rtol=0, atol=1e-12)
    np.testing.assert_allclose(tgeo.edge_normals(et), jgeo.edge_normals(ej),
                               rtol=0, atol=1e-12)
    Q = _points(31, seed=n + 100, kind="gaussian")
    np.testing.assert_array_equal(tgeo.project_to_hull_boundary(Q, et),
                                  jgeo.project_to_hull_boundary(Q, ej))
    np.testing.assert_array_equal(
        tgeo.project_to_hull_boundary(Q[:0], et),
        jgeo.project_to_hull_boundary(Q[:0], ej))
    w = np.random.default_rng(n).random(len(ht))
    for weights in (w, np.zeros_like(w), np.ones_like(w)):
        assert tgeo.weighted_median_index(weights) == \
            jgeo.weighted_median_index(weights)


# -- (b) the range scans on the device path ------------------------------------

def _ulp_equal(a, b, scale, what):
    """±inf exact; finite values within one f32 ulp of ``scale``, the
    largest term a projection sums (unit directions: the transcript's
    largest row norm) — one rounding of a product-sum more or less."""
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    assert np.array_equal(np.isinf(a), np.isinf(b)), what
    fin = np.isfinite(b)
    assert np.array_equal(a[~fin], b[~fin]), what
    gap = np.abs(a[fin].astype(np.float64) - b[fin])
    assert (gap <= np.spacing(np.float32(scale))).all(), (what, gap.max())


@pytest.mark.parametrize("d", [2, 3])
@pytest.mark.parametrize("n_w", [0, 1, 9, 120])
def test_ranges_and_uncertainty_equal_jax(d, n_w):
    """Label-0 transcript rows are inert, an empty transcript gives -inf /
    +inf (and every allowed direction puts every point at risk), and a
    transcript with one class leaves the other bound infinite."""
    rng = np.random.default_rng(7 * d + n_w)
    m = 96
    V = rng.normal(size=(m, d)).astype(np.float32)
    V /= np.linalg.norm(V, axis=1, keepdims=True)
    Xw = rng.normal(size=(n_w, d)).astype(np.float32)
    yw = rng.choice(np.array([1, -1, 0], np.int32), size=n_w)
    X = rng.normal(size=(150, d)).astype(np.float32)
    y = rng.choice(np.array([1, -1], np.int32), size=150)
    dir_ok = rng.random(m) < 0.7
    for yw_case in (yw, np.where(yw == -1, 1, yw).astype(np.int32)):
        lo_j, hi_j = jgeo.consistent_threshold_ranges(
            jnp.asarray(V), jnp.asarray(Xw), jnp.asarray(yw_case))
        lo_t, hi_t = tgeo.consistent_threshold_ranges(
            torch.as_tensor(V), torch.as_tensor(Xw), torch.as_tensor(yw_case))
        scale = np.linalg.norm(Xw, axis=1).max(initial=0.0)
        _ulp_equal(lo_t.numpy(), lo_j, scale, "lo")
        _ulp_equal(hi_t.numpy(), hi_j, scale, "hi")
        mj = jgeo.uncertain_mask(jnp.asarray(V), jnp.asarray(dir_ok),
                                 jnp.asarray(Xw), jnp.asarray(yw_case),
                                 jnp.asarray(X), jnp.asarray(y))
        mt = tgeo.uncertain_mask(torch.as_tensor(V), torch.as_tensor(dir_ok),
                                 torch.as_tensor(Xw),
                                 torch.as_tensor(yw_case), torch.as_tensor(X),
                                 torch.as_tensor(y))
        np.testing.assert_array_equal(mt.numpy(), np.asarray(mj))
    if n_w == 0:
        assert np.isneginf(lo_t.numpy()).all() and mt.numpy().all()


def _mid_protocol_node(seed=0):
    """Node A of data3 with node B's whole shard as its transcript: its
    SOU and risk matrix are neither empty nor full."""
    shards = datasets.data3(n_per_node=120, k=2, seed=seed)
    Xb, yb = shards[1]
    return shards, Xb, yb.astype(np.int32)


def test_risk_matrix_and_sou_equal_jax():
    shards, Wx, Wy = _mid_protocol_node()
    (ja, _), _ = jmake_nodes(shards)
    (ta, _), _ = tmake_nodes(shards)
    V = np.asarray(jgeo.direction_grid(256))
    dir_ok = np.ones(256, bool)
    dir_ok[40:90] = False
    rj = jtw._risk_matrix(ja, V, dir_ok, Wx, Wy)
    rt = ttw._risk_matrix(ta, V, dir_ok, Wx, Wy, device="cpu")
    np.testing.assert_array_equal(rt, rj)
    assert 0 < rt.sum() < rt.size
    assert ttw._pick_median_direction(rt, dir_ok) == \
        jtw._pick_median_direction(rj, dir_ok)
    # over every allowed direction each point is at risk somewhere; along
    # the middle consistent direction alone only the band's points are
    lo, hi = jgeo.consistent_threshold_ranges(jnp.asarray(V),
                                              jnp.asarray(Wx),
                                              jnp.asarray(Wy))
    sep = np.flatnonzero(np.asarray(lo) < np.asarray(hi))
    narrow = np.zeros(256, bool)
    narrow[sep[len(sep) // 2]] = True
    for ok in (dir_ok, narrow):
        sj = jtw._sou(ja, V, ok, Wx, Wy)
        st = ttw._sou(ta, V, ok, Wx, Wy, device="cpu")
        np.testing.assert_array_equal(st, sj)
    assert 0 < st.sum() < st.size
    np.testing.assert_array_equal(
        ttw._risk_matrix(ta, V, dir_ok, Wx[:0], Wy[:0], device="cpu"),
        jtw._risk_matrix(ja, V, dir_ok, Wx[:0], Wy[:0]))
    assert ttw._sou(ta, V, dir_ok, Wx[:0], Wy[:0], device="cpu").all()


# -- (c) the single-instance solver --------------------------------------------

@pytest.mark.parametrize("rate,steps", [(0.0, 500), (0.05, 3000)])
def test_svm_solve_equals_jax(rate, steps):
    shards = datasets.data3(n_per_node=200, k=2, seed=1)
    if rate:
        shards = datasets.add_label_noise(shards, rate)
    X, y = shards[0]
    wj, bj = jclf._svm_solve(jnp.asarray(X, jnp.float32),
                             jnp.asarray(y, jnp.float32), jnp.float32(1e-2),
                             steps)
    wt, bt = tclf._svm_solve(torch.as_tensor(X), torch.as_tensor(y), 1e-2,
                             steps)
    assert wt.shape == (2,) and bt.shape == () and wt.dtype == torch.float32
    ref = np.concatenate([np.asarray(wj), [float(bj)]])
    got = np.concatenate([wt.numpy(), [float(bt)]])
    scale = np.abs(ref).max()
    assert np.abs(got - ref).max() <= 1e-3 * scale, (got, ref)


# -- (d) the protocols ---------------------------------------------------------

@pytest.fixture
def jax_grid(monkeypatch):
    """The port's protocols on JAX's f32 direction grid (the two grids
    differ by 1 ulp on a few entries)."""
    def carried(n_angles, device="cuda"):
        return torch.as_tensor(np.array(jgeo.direction_grid(n_angles))).to(
            device)
    monkeypatch.setattr(tgeo, "direction_grid", carried)


def _same_result(a, b, atol):
    assert a.comm == b.comm, (a.comm, b.comm)
    assert (a.rounds, a.converged) == (b.rounds, b.converged)
    assert a.extra == b.extra
    scale = max(np.abs(a.classifier.w).max(), abs(a.classifier.b), 1.0)
    np.testing.assert_allclose(b.classifier.w, a.classifier.w, rtol=0,
                               atol=atol * scale)
    assert abs(b.classifier.b - a.classifier.b) <= atol * scale


@pytest.mark.parametrize("gen", ["data1", "data2", "data3"])
def test_median_bit_equals_jax(jax_grid, gen):
    """Separable data (ending in 1–2 rounds): everything exact, the
    separator to 1e-6."""
    shards = getattr(datasets, gen)(n_per_node=150, k=2, seed=0)
    a = jtw.iterative_support_median_bit(shards, eps=0.05, n_angles=256)
    b = ttw.iterative_support_median_bit(shards, eps=0.05, n_angles=256,
                                         device="cpu")
    _same_result(a, b, 1e-6)
    assert b.converged


def _recording(monkeypatch, module, log):
    real = module._risk_matrix

    def rec(node, V, dir_ok, Wx, Wy, *args, **kw):
        risk = real(node, V, dir_ok, Wx, Wy, *args, **kw)
        log.append((node.X.copy(), np.asarray(Wx).copy(), dir_ok.copy(),
                    risk))
        return risk
    monkeypatch.setattr(module, "_risk_matrix", rec)


@pytest.mark.parametrize("gen", ["data1", "data2", "data3"])
def test_median_bit_noisy_runs_equal_jax_up_to_self_ties(jax_grid,
                                                          monkeypatch, gen):
    """5% label noise at ε=0.02: no round terminates, so all 64 rounds of
    rotation bits and range scans run.  Comm, rounds and convergence are
    exact.  The sender's risk matrix compares float64 projections of its
    points with f32 bounds from its transcript; where a point is in that
    transcript (it shipped it), its bound is built from its own
    projection, and JAX's ``V @ Xw.T`` (XLA may fuse it into an FMA) and
    the port's per-operation rounding can put the point on either side.
    Every difference between the two risk matrices, up to the first round
    whose pick differs, is such a self-tie (ROADMAP Queue 3); where no pick
    differs the separators agree to 1e-6."""
    shards = datasets.add_label_noise(
        getattr(datasets, gen)(n_per_node=150, k=2, seed=0), 0.05, seed=1)
    logs = {"jax": [], "port": []}
    _recording(monkeypatch, jtw, logs["jax"])
    _recording(monkeypatch, ttw, logs["port"])
    a = jtw.iterative_support_median_bit(shards, eps=0.02, n_angles=256)
    b = ttw.iterative_support_median_bit(shards, eps=0.02, n_angles=256,
                                         device="cpu")
    assert a.comm == b.comm and b.rounds == a.rounds == 64
    assert not a.converged and not b.converged
    assert len(logs["jax"]) == len(logs["port"]) == 64
    diverged = False
    for (X, Wx, ok_j, rj), (_X, _Wx, ok_t, rt) in zip(logs["jax"],
                                                      logs["port"]):
        np.testing.assert_array_equal(ok_t, ok_j)
        np.testing.assert_array_equal(_Wx, Wx)
        for _i, j in np.argwhere(rj != rt):
            assert (Wx == X[j]).all(axis=1).any(), "not a self-tie"
        if jtw._pick_median_direction(rj, ok_j) != \
                ttw._pick_median_direction(rt, ok_t):
            diverged = True
            break
    if not diverged:
        _same_result(a, b, 1e-6)


def test_median_bit_requires_the_plane():
    with pytest.raises(ValueError, match="R\\^2"):
        ttw.iterative_support_median_bit(
            datasets.data_highd(n_per_node=20, k=2, d=3, seed=0),
            device="cpu")


@pytest.mark.parametrize("rate", [0.05, 0.10])
def test_noisy_protocol_equals_jax(rate):
    noisy = datasets.add_label_noise(
        datasets.data3(n_per_node=250, k=2, seed=0), rate)
    a = jtw.iterative_support_noisy(noisy, eps=0.05)
    b = ttw.iterative_support_noisy(noisy, eps=0.05, device="cpu")
    _same_result(a, b, 1e-3)
    assert b.converged and b.comm["points"] <= 60
