"""The port's unified mixed-selector dispatch (``repro_torch.engine.unified``)
held against the JAX reference (``repro.engine.unified``) on the CPU.

Inputs are seeded numpy shards at ``tests/test_unified.py``'s sizes
(N_PAD 16, 64 angles, 8 epochs, its interleaved MEDIAN / MAXMARG /
SAMPLING mix); the JAX package's packed state is carried across with
``from_reference`` wherever one step is compared.

Tolerances:

* integer leaves and outputs (labels, fills, turns, flags, latches,
  reservoir counters, every comm counter, rounds, ``sample_size``,
  ``warm_latches``): exact;
* transcript points ``wx`` and the MEDIAN arc (``lo_w``/``hi_w``): bit for
  bit against JAX's step compiled with XLA's fusion pass off (the FMA
  contraction of the fused step, tests/test_torch_median.py);
* MEDIAN separators: bit for bit against the unfused step, to atol 1e-5
  against the fused sweep, bit for bit against the port's bucketed sweep;
* MAXMARG and SAMPLING separators and carries: within 1e-4 of the row's
  largest coordinate per step, and a cosine above 1 - 1e-4 over a sweep —
  the tier of tests/test_torch_maxmarg.py.
"""

import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

from repro import engine as jeng
from repro.core import datasets, geometry as jgeo
from repro.engine import hotloop as jhot, unified as juni

import torch

from repro_torch import engine as teng
from repro_torch.engine import hotloop as thot, unified as tuni

N_PAD = 16
N_ANGLES = 64
MAX_EPOCHS = 8
STEPS = 400
COS = 1e-4
REL = 1e-4
UNFUSED = {"xla_disable_hlo_passes": "fusion"}
_GENS = (datasets.data1, datasets.data2, datasets.data3)
_MIX = ("median", "maxmarg", "sampling")


def _mixed_instances(n, k=2, n_per_node=N_PAD, seed0=0):
    """tests/test_unified.py's mix: interleaved families over staggered
    datasets and ε, uniform shard sizes."""
    return [jeng.ProtocolInstance(
        _GENS[i % 3](n_per_node=n_per_node, k=k, seed=seed0 + i),
        eps=(0.1, 0.05, 0.05)[i % 3], selector=_MIX[i % 3],
        seed=seed0 + i) for i in range(n)]


def _port(insts):
    return [teng.ProtocolInstance(i.shards, i.eps, i.selector, i.seed)
            for i in insts]


def _canon(h):
    v = np.concatenate([h.w, [h.b]])
    return v / (np.linalg.norm(v) + 1e-30)


def _assert_results(rj, rt, *, median_atol=1e-5, median_bitwise=False):
    """Exact integers and extras; MEDIAN separators to ``median_atol`` (or
    bit for bit); MAXMARG and SAMPLING directions to the cosine tier."""
    assert len(rj) == len(rt)
    for i, (a, b) in enumerate(zip(rj, rt)):
        sel = a.extra["selector"]
        assert b.extra["selector"] == sel, i
        assert a.comm == b.comm, (i, sel, a.comm, b.comm)
        assert (a.rounds, a.converged) == (b.rounds, b.converged), (i, sel)
        for key in ("sample_size", "warm_latches"):
            assert a.extra.get(key) == b.extra.get(key), (i, sel, key)
        if sel == "median":
            if median_bitwise:
                assert np.array_equal(a.classifier.w, b.classifier.w), i
                assert float(a.classifier.b) == float(b.classifier.b), i
            else:
                np.testing.assert_allclose(b.classifier.w, a.classifier.w,
                                           rtol=0, atol=median_atol)
                assert abs(b.classifier.b - a.classifier.b) <= median_atol
        else:
            assert float(_canon(a.classifier) @ _canon(b.classifier)) \
                > 1.0 - COS, (i, sel)


# -- (a) packing --------------------------------------------------------------

_PACKS = {
    "k2": lambda: _mixed_instances(9),
    "k3": lambda: _mixed_instances(6, k=3, seed0=7),
    "median_free": lambda: [i for i in _mixed_instances(8)
                            if i.selector != "median"],
    "ragged": lambda: _mixed_instances(5) + [jeng.ProtocolInstance(
        [(s[0][:11], s[1][:11]) for s in _mixed_instances(6)[5].shards],
        0.02, "sampling", 99)],
}


@pytest.mark.parametrize("case", sorted(_PACKS))
def test_pack_unified_every_leaf_equal(case):
    """Leaf for leaf against the JAX package's packing, ``hop_keys`` equal
    in value (int64 words against uint32), and ``from_reference`` carries
    the JAX state onto the same tensors."""
    insts = _PACKS[case]()
    kw = dict(n_angles=N_ANGLES, max_epochs=MAX_EPOCHS, max_support=4)
    jd, js, k, cap = jeng.pack_instances_unified(insts, **kw)
    td, ts, tk, tcap = teng.pack_instances_unified(_port(insts),
                                                   device="cpu", **kw)
    assert (tk, tcap) == (k, cap)
    for a, b in zip(jd, td):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    assert ts.hop_keys.dtype == torch.int64
    for f in js._fields:
        a, b = getattr(js, f), getattr(ts, f)
        if f == "comm":
            for g in a._fields:
                np.testing.assert_array_equal(getattr(b, g).numpy(),
                                              np.asarray(getattr(a, g)))
            continue
        np.testing.assert_array_equal(b.numpy(),
                                      np.asarray(a).astype(b.numpy().dtype),
                                      err_msg=f)
        assert b.numpy().dtype == np.asarray(a).dtype or f == "hop_keys", f
    V = (jgeo.direction_grid(N_ANGLES) if "median" in
         [i.selector for i in insts] else np.zeros((1, 2), np.float32))
    cd, cs, cV = teng.from_reference(jd, js, V, device="cpu")
    for a, b in zip(cs, ts):
        for x, y in (zip(a, b) if isinstance(a, tuple) else [(a, b)]):
            assert torch.equal(x, y)
    assert cV.shape == np.shape(V)
    with pytest.raises(ValueError, match="direction grid"):
        teng.from_reference(jd, js, device="cpu")


# -- (b) one step, JAX's state carried across every turn ----------------------

class _Unfused:
    """JAX's unified ``step``, compiled per static variant with XLA's fusion
    pass off (tests/test_torch_median.py's reference arithmetic)."""

    def __init__(self):
        self.cache = {}

    def step(self, data, V, s, **kw):
        key = (tuple(np.shape(s.wx)), tuple(sorted(kw.items())))
        if key not in self.cache:
            self.cache[key] = jax.jit(
                lambda data, V, s: juni.step(data, V, s, **kw)).lower(
                    data, V, s).compile(compiler_options=UNFUSED)
        return self.cache[key](data, V, s)


_INT_LEAVES = ("sel", "dir_ok", "wy", "w_fill", "turn", "done", "converged",
               "epochs", "h_valid", "warm_turn", "c_valid", "warm_node",
               "latches", "seen", "res_cap")
_EXACT_FLOATS = ("wx", "lo_w", "hi_w")


def _assert_unified_state(js, ts, what):
    for f in _INT_LEAVES + _EXACT_FLOATS:
        np.testing.assert_array_equal(getattr(ts, f).numpy(),
                                      np.asarray(getattr(js, f)),
                                      err_msg=f"{what} {f}")
    np.testing.assert_array_equal(ts.hop_keys.numpy(),
                                  np.asarray(js.hop_keys, np.int64))
    for f in js.comm._fields:
        np.testing.assert_array_equal(getattr(ts.comm, f).numpy(),
                                      np.asarray(getattr(js.comm, f)),
                                      err_msg=f"{what} comm.{f}")
    med = np.asarray(js.sel) == 0
    for f in ("h_w", "h_b"):        # MEDIAN rows bit for bit
        np.testing.assert_array_equal(getattr(ts, f).numpy()[med],
                                      np.asarray(getattr(js, f))[med],
                                      err_msg=f"{what} median {f}")
    for f in ("h_w", "h_b", "c_w", "c_b"):
        a = np.asarray(getattr(js, f))
        b = getattr(ts, f).numpy()
        scale = np.abs(a).reshape(a.shape[0], -1).max(axis=1)
        err = np.abs(a - b).reshape(a.shape[0], -1).max(axis=1)
        assert (err <= REL * scale).all(), (what, f, err, scale)


@pytest.mark.parametrize("k", [2, 3])
def test_step_matches_unfused_reference_every_leaf_every_turn(k):
    """Every turn of a mixed sweep at the full width (the MEDIAN substep's
    constant-folded first turn included): the port steps from the JAX
    state carried across, against JAX's step compiled unfused."""
    insts = (_mixed_instances(9) if k == 2
             else _mixed_instances(6, k=3, seed0=7))
    jd, js, k, _cap = jeng.pack_instances_unified(
        insts, n_angles=N_ANGLES, max_epochs=MAX_EPOCHS, max_support=4)
    V = jgeo.direction_grid(N_ANGLES)
    ref = _Unfused()
    opts = dict(k=k, max_support=4, steps=STEPS, stages=3, lam0=1e-3,
                per_node=True)
    for t in range(2 * k + 1):      # hops, fit turns, two MEDIAN epochs
        if bool(np.asarray(js.done).all()):
            break
        td, ts, tV = teng.from_reference(jd, js, V, device="cpu")
        tnext = tuni.step(td, tV, ts, first_turn=(t == 0), **opts)
        js = ref.step(jd, V, js, first_turn=(t == 0), **opts)
        _assert_unified_state(js, tnext, f"turn {t}")
    assert t >= k


# -- (c) sweeps ---------------------------------------------------------------

@pytest.fixture(scope="module")
def sweeps():
    runs = {}
    for name, insts in (("k2", _mixed_instances(6)),
                        ("k3", _mixed_instances(6, k=3, seed0=7))):
        kw = dict(n_angles=N_ANGLES, max_epochs=MAX_EPOCHS, steps=STEPS)
        jhot.KEY_LOG.clear()
        rj = jeng.run_sweep(insts, unified_dispatch=True, **kw)
        jkeys = list(jhot.KEY_LOG)
        thot.KEY_LOG.clear()
        rt = teng.run_sweep(_port(insts), unified_dispatch=True,
                            device="cpu", **kw)
        tkeys = list(thot.KEY_LOG)
        rb = teng.run_sweep(_port(insts), device="cpu", **kw)
        runs[name] = (rj, rt, rb, jkeys, tkeys)
    return runs


@pytest.mark.parametrize("k", ["k2", "k3"])
def test_unified_sweep_matches_reference(sweeps, k):
    """The fused JAX unified sweep as users run it: integers exact, MEDIAN
    to 1e-5, MAXMARG and SAMPLING to the cosine tier; the geometric
    buckets give the JAX loop's launch shapes."""
    rj, rt, _rb, jkeys, tkeys = sweeps[k]
    _assert_results(rj, rt)
    assert all(r.extra["unified"] and r.extra["device"] == "cpu"
               for r in rt)
    assert tkeys == jkeys
    assert {r.extra["selector"] for r in rt} == set(_MIX)


@pytest.mark.parametrize("k", ["k2", "k3"])
def test_unified_sweep_matches_port_bucketed(sweeps, k):
    """One dispatch against the port's per-selector buckets: MEDIAN bit for
    bit, the other families exact in decisions and to the cosine tier."""
    _rj, rt, rb, _jk, _tk = sweeps[k]
    _assert_results(rb, rt, median_bitwise=True)


def test_median_free_mix_matches_reference():
    """A median-free mix carries 1-wide stub arcs and leaves the MEDIAN
    substep out."""
    insts = [i for i in _mixed_instances(8) if i.selector != "median"]
    kw = dict(max_epochs=MAX_EPOCHS, steps=STEPS)
    rj = juni.run_instances(insts, **kw)
    rt = tuni.run_instances(_port(insts), device="cpu", **kw)
    _assert_results(rj, rt)
    _assert_results(teng.run_sweep(_port(insts), device="cpu", **kw), rt)


def test_readme_quick_start_mix_runs():
    """The README's quick start (data1, n_per_node 64, one instance per
    family, default options) through the port's
    ``run_sweep(unified_dispatch=True)``, against the port's buckets."""
    insts = _port([jeng.ProtocolInstance(
        datasets.data1(n_per_node=64, k=2, seed=s), eps=0.05, selector=sel,
        seed=s) for s, sel in enumerate(_MIX)])
    rt = teng.run_sweep(insts, unified_dispatch=True, device="cpu")
    _assert_results(teng.run_sweep(insts, device="cpu"), rt,
                    median_bitwise=True)
    assert all(r.converged for r in rt)


def test_unified_refuses_what_is_not_ported():
    """``stats`` is taken as in the JAX package (the unified path has no
    mesh, so the dict stays empty and the results are those of a run
    without it); the baselines are not unified families; an unknown width
    policy raises."""
    insts = _port(_mixed_instances(3))
    stats = {}
    with_stats = teng.run_sweep(insts, unified_dispatch=True, stats=stats,
                                device="cpu")
    assert stats == {}
    _assert_results(tuni.run_instances(insts, device="cpu"), with_stats,
                    median_bitwise=True)
    tuni.run_instances(insts, stats=stats, device="cpu")
    assert stats == {}
    with pytest.raises(ValueError, match="unified packing covers"):
        teng.pack_instances_unified(
            [teng.ProtocolInstance(insts[0].shards, 0.1, "voting")],
            n_angles=8, max_epochs=2, max_support=4, device="cpu")
    with pytest.raises(ValueError, match="width policy"):
        thot.quantize_width(20, 64, "bogus")


# -- (d) width buckets -------------------------------------------------------

@pytest.mark.parametrize("cap,policy", [
    (c, p) for c in (8, 56, 104, 248, 1712) for p in ("linear", "geometric")])
def test_quantize_width_equals_reference(cap, policy):
    got = [thot.quantize_width(w, cap, policy) for w in range(cap + 1)]
    want = [jhot.quantize_width(w, cap, policy) for w in range(cap + 1)]
    assert got == want
    assert got[0] == 0 and all(w <= q <= cap for w, q in enumerate(got))
