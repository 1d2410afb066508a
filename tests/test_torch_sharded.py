"""The port's sharded B axis (``repro_torch.launch.mesh`` and the engine's
``mesh=`` path) held against the port's own unsharded sweeps and the JAX
reference's unsharded engine, on the CPU.

A sharded sweep splits the instance axis over a 1-D ("data",) mesh; here
the mesh repeats the CPU device, so S logical shards run in one process
(the counterpart of JAX's forced host devices, which the JAX package's
own sharded tests need before JAX starts).  Every shard runs the
unchanged single-device step on its slice, so:

* against the port's unsharded run (same ``overlap``): MEDIAN and MAXMARG
  bit for bit — comm, rounds, convergence and every separator float;
* against JAX's unsharded engine: JAX's tiers — integers exact, MEDIAN
  bitwise against the reference's step compiled with XLA's fusion pass
  off (the port rounds each operation) and to 1e-5 against the fused
  engine, MAXMARG directions to a cosine of 1 - 1e-4;
* ``shard_skew`` / ``balanced_index`` against JAX's, array for array.
"""

import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

from repro import engine as jeng
from repro.core import datasets, geometry as jgeo
from repro.engine import hotloop as jhot, median as jmed

import torch

from repro_torch import engine as teng
from repro_torch.engine import hotloop as thot, maxmarg as tmm
from repro_torch.engine import median as tmed, state as tstate
from repro_torch.engine import unified as tuni
from repro_torch.launch.mesh import DataMesh, make_data_mesh

N_ANGLES = 128
MAX_EPOCHS = 8
STEPS = 400
COS = 1e-4
UNFUSED = {"xla_disable_hlo_passes": "fusion"}
_GENS = (datasets.data1, datasets.data2, datasets.data3)


def _mesh(S):
    return make_data_mesh(device=["cpu"] * S)


def _grid(n, k=2, selector="median", n_per_node=30, noisy_every=0):
    """n instances cycling datasets, ε and seeds, so convergence staggers
    and the shard-balanced sub-batch path engages; every ``noisy_every``-th
    instance gets 10% label noise and ε=0.02 and runs the whole budget."""
    out = []
    for i in range(n):
        shards = _GENS[i % 3](n_per_node=n_per_node, k=k, seed=i)
        eps = (0.1, 0.05)[i % 2]
        if noisy_every and i % noisy_every == 0:
            shards = datasets.add_label_noise(shards, 0.1, seed=i)
            eps = 0.02
        out.append(teng.ProtocolInstance(shards, eps, selector))
    return out


def _jax(insts):
    return [jeng.ProtocolInstance(i.shards, i.eps, i.selector)
            for i in insts]


def _bitwise(a_res, b_res):
    assert len(a_res) == len(b_res)
    for i, (a, b) in enumerate(zip(a_res, b_res)):
        assert a.comm == b.comm, (i, a.comm, b.comm)
        assert (a.rounds, a.converged) == (b.rounds, b.converged), i
        np.testing.assert_array_equal(a.classifier.w, b.classifier.w)
        assert a.classifier.b == b.classifier.b, i


def _canon(h):
    v = np.concatenate([h.w, [h.b]])
    return v / (np.linalg.norm(v) + 1e-30)


def _jax_tier(rj, rt, selector):
    for i, (a, b) in enumerate(zip(rj, rt)):
        assert a.comm == b.comm, (i, a.comm, b.comm)
        assert (a.rounds, a.converged) == (b.rounds, b.converged), i
        if selector == "median":
            np.testing.assert_allclose(b.classifier.w, a.classifier.w,
                                       rtol=0, atol=1e-5)
            assert abs(b.classifier.b - a.classifier.b) <= 1e-5, i
        else:
            assert float(_canon(a.classifier) @ _canon(b.classifier)) \
                > 1.0 - COS, i


# -- (a) the host-side shard arithmetic against JAX's ------------------------

ADVERSARIAL = [
    ("one_shard_full", lambda B, S: np.arange(B // S)),
    ("last_shard_only", lambda B, S: np.arange(B - B // S, B)),
    ("alternating", lambda B, S: np.arange(0, B, 2)),
    ("single_survivor", lambda B, S: np.array([B - 1])),
    ("one_per_shard", lambda B, S: np.arange(S) * (B // S)),
    ("saturated", lambda B, S: np.arange(B)),
    ("empty", lambda B, S: np.array([], np.int64)),
]


def _same_index(act, B, S):
    ij, nj = jhot.balanced_index(act, B, S)
    it, nt = thot.balanced_index(act, B, S)
    np.testing.assert_array_equal(it, ij)
    np.testing.assert_array_equal(nt, nj)
    assert it.dtype == ij.dtype and nt.dtype == nj.dtype
    assert thot.shard_skew(nt) == jhot.shard_skew(nj)
    return nt


@pytest.mark.parametrize("name,gen", ADVERSARIAL,
                         ids=[n for n, _ in ADVERSARIAL])
@pytest.mark.parametrize("B,S", [(16, 2), (32, 4), (64, 8)])
def test_balanced_index_adversarial_masks_equal_jax(name, gen, B, S):
    act = np.sort(np.asarray(gen(B, S), np.int64))
    n_act = _same_index(act, B, S)
    if name == "empty":
        assert thot.shard_skew(n_act) == 0.0
    elif name in ("one_shard_full", "last_shard_only", "single_survivor"):
        assert thot.shard_skew(n_act) == float(S)


@pytest.mark.parametrize("B,S", [(16, 2), (32, 4), (48, 4), (64, 8)])
def test_balanced_index_seeded_masks_equal_jax(B, S):
    rng = np.random.default_rng(B * 31 + S)
    for trial in range(50):
        mask = rng.random(B) < rng.uniform(0.05, 0.95)
        if trial % 3 == 0:          # skew hard toward the first shard
            mask[B // S:] &= rng.random(B - B // S) < 0.1
        _same_index(np.flatnonzero(mask), B, S)
    for counts in ([8, 8, 8, 8], [16, 0, 8, 8], [0, 0, 0], [3], []):
        assert thot.shard_skew(np.array(counts)) == \
            jhot.shard_skew(np.array(counts))


# -- (b) the mesh and the sharded records ------------------------------------

def test_make_data_mesh_bounds_and_explicit_devices():
    one = make_data_mesh(device="cpu")
    assert one.shape == {"data": 1} and one.axis_names == ("data",)
    rep = make_data_mesh(device=["cpu"] * 4)
    assert rep.shape["data"] == 4 and len(rep.devices) == 4
    assert make_data_mesh(2, device=["cpu"] * 4).devices == \
        (torch.device("cpu"),) * 2
    for bad in (0, 5, -1):
        with pytest.raises(ValueError, match="n_devices"):
            make_data_mesh(bad, device=["cpu"] * 4)
    with pytest.raises(ValueError, match="n_devices"):
        make_data_mesh(2, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make_data_mesh()


@pytest.mark.parametrize("S", [2, 4])
def test_pack_with_mesh_pads_born_done_and_owns_its_shards(S):
    """B pads to a multiple of S with born-done all-zero instances; every
    shard holds its rows in tensors of its own (never a view of another
    shard or of the input), and ``unshard`` restores the padded record;
    ``shard_specs`` is JAX's rule leaf for leaf."""
    insts = _grid(S + 1)
    data, s0, k, cap = teng.pack_instances(insts, n_angles=16, max_epochs=2,
                                           mesh=_mesh(S))
    flat, f0, _, _ = teng.pack_instances(insts, n_angles=16, max_epochs=2,
                                         device="cpu")
    assert len(data) == len(s0) == S
    B = 2 * S
    full, full0 = tstate.unshard(data), tstate.unshard(s0)
    assert full0.done.tolist() == [False] * (S + 1) + [True] * (S - 1)
    assert torch.equal(full.X[:S + 1], flat.X) and not full.X[S + 1:].any()
    assert int(full.budget[S + 1:].abs().sum()) == 0
    for f in s0[0]._fields:
        if f not in ("done", "comm"):
            assert torch.equal(getattr(full0, f)[:S + 1], getattr(f0, f)), f
    ptrs = [t.data_ptr() for p in list(data) + list(s0)
            for t in tstate._leaves(p)]
    assert len(set(ptrs)) == len(ptrs)
    assert all(p.done.shape[0] == B // S for p in s0)
    jdata, js0, _, _ = jeng.pack_instances(_jax(insts), n_angles=16,
                                           max_epochs=2)
    for ours, theirs in ((data[0], jdata), (s0[0], js0)):
        jspec = jax.tree_util.tree_leaves(
            jeng.state.shard_specs(theirs),
            is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
        assert [tuple(p) for p in jspec] == \
            _spec_leaves(tstate.shard_specs(ours))


def _spec_leaves(rec):
    if hasattr(rec, "_fields"):
        return [x for f in rec for x in _spec_leaves(f)]
    return [rec]


# -- (c) MEDIAN ----------------------------------------------------------------

@pytest.fixture(scope="module")
def median_grid():
    """A staggered grid with a noisy tail (sub-batch turns on every shard,
    the tail through the whole budget), run once by JAX's fused engine and
    by the port unsharded, with and without double buffering."""
    insts = _grid(9, noisy_every=4)
    opts = dict(n_angles=N_ANGLES, max_epochs=MAX_EPOCHS)
    return dict(
        insts=insts, opts=opts,
        jax=jeng.run_instances(_jax(insts), **opts),
        port={ov: teng.run_instances(insts, overlap=ov, device="cpu", **opts)
              for ov in (False, True)})


@pytest.mark.parametrize("B", [8, 9], ids=["divisible", "padded"])
@pytest.mark.parametrize("overlap", [False, True], ids=["plain", "overlap"])
@pytest.mark.parametrize("S", [2, 4])
def test_median_sharded_bitwise_against_unsharded(median_grid, S, overlap, B):
    insts = median_grid["insts"][:B]
    stats = {}
    sh = teng.run_instances(insts, mesh=_mesh(S), overlap=overlap,
                            stats=stats, device="cpu", **median_grid["opts"])
    _bitwise(sh, median_grid["port"][overlap][:B])
    _jax_tier(median_grid["jax"][:B], sh, "median")
    assert all(r.extra["devices"] == S for r in sh)
    assert stats["shard_dispatches"] >= 1
    assert sum(not r.converged for r in sh) == len(range(0, B, 4))


@pytest.mark.parametrize("S", [2, 4])
def test_median_sharded_bitwise_against_reference_unfused(S):
    """JAX's packed inputs and grid carried across: the port's sharded hot
    loop against JAX's cold model compiled unfused, every output leaf bit
    for bit (JAX holds its cold model bit-exact to its hot path)."""
    insts = _grid(8, noisy_every=4)
    data, state0, k, _cap = jeng.pack_instances(
        _jax(insts), n_angles=N_ANGLES, max_epochs=MAX_EPOCHS)
    V = jgeo.direction_grid(N_ANGLES)
    kw = dict(k=k, max_turns=k * MAX_EPOCHS)
    cold = jax.jit(jmed.run_compiled.__wrapped__,
                   static_argnames=tuple(kw)).lower(
        data, V, state0, **kw).compile(compiler_options=UNFUSED)(
        data, V, state0)
    data_t, s0, Vt = teng.from_reference(data, state0, V, device="cpu")
    shards = tmed.run_hot(data_t, Vt, s0, mesh=_mesh(S), **kw)
    assert len(shards) == S
    final = tstate.unshard(shards)
    for f in ("done", "converged", "epochs", "h_v", "h_t", "h_valid",
              "dir_ok"):
        np.testing.assert_array_equal(getattr(final, f).numpy(),
                                      np.asarray(getattr(cold, f)), f)
    for f in final.comm._fields:
        np.testing.assert_array_equal(getattr(final.comm, f).numpy(),
                                      np.asarray(getattr(cold.comm, f)), f)
    # the caller's state was packed, not donated: it is untouched
    assert int(s0.turn.max()) == 0


def test_median_sharded_kparty():
    insts = [teng.ProtocolInstance(datasets.data3(n_per_node=30, k=4,
                                                  seed=s), eps)
             for s, eps in ((0, 0.1), (1, 0.05), (2, 0.1), (3, 0.05),
                            (4, 0.02))]
    opts = dict(n_angles=N_ANGLES, max_epochs=MAX_EPOCHS)
    sh = teng.run_instances(insts, mesh=_mesh(2), device="cpu", **opts)
    _bitwise(sh, teng.run_instances(insts, overlap=True, device="cpu",
                                    **opts))
    _jax_tier(jeng.run_instances(_jax(insts), **opts), sh, "median")


# -- (d) MAXMARG -------------------------------------------------------------

@pytest.fixture(scope="module")
def maxmarg_grid():
    insts = _grid(7, k=3, selector="maxmarg")
    opts = dict(max_epochs=MAX_EPOCHS, steps=STEPS)
    return dict(insts=insts, opts=opts,
                jax=jeng.maxmarg.run_instances(_jax(insts), **opts),
                port={ov: tmm.run_instances(insts, overlap=ov, device="cpu",
                                            **opts)
                      for ov in (False, True)})


@pytest.mark.parametrize("overlap", [False, True], ids=["plain", "overlap"])
@pytest.mark.parametrize("S", [2, 4])
def test_maxmarg_sharded_bitwise_against_unsharded(maxmarg_grid, S, overlap):
    """k=3 (the per-node warm carries), B=7 (padded for both meshes)."""
    stats = {}
    sh = tmm.run_instances(maxmarg_grid["insts"], mesh=_mesh(S),
                           overlap=overlap, stats=stats, device="cpu",
                           **maxmarg_grid["opts"])
    _bitwise(sh, maxmarg_grid["port"][overlap])
    _jax_tier(maxmarg_grid["jax"], sh, "maxmarg")
    assert all(r.extra["devices"] == S for r in sh)
    assert [r.extra["warm_latches"] for r in sh] == \
        [r.extra["warm_latches"] for r in maxmarg_grid["port"][overlap]]


def test_run_sweep_mesh_passthrough():
    """A mixed MEDIAN + MAXMARG sweep rides the sharded path per bucket."""
    insts = _grid(3) + _grid(3, selector="maxmarg")
    opts = dict(n_angles=N_ANGLES, max_epochs=MAX_EPOCHS, steps=STEPS)
    sh = teng.run_sweep(insts, mesh=_mesh(2), device="cpu", **opts)
    _bitwise(sh, teng.run_sweep(insts, overlap=True, device="cpu", **opts))
    rj = jeng.run_sweep(_jax(insts), **opts)
    _jax_tier(rj[:3], sh[:3], "median")
    _jax_tier(rj[3:], sh[3:], "maxmarg")
    assert all(r.extra["devices"] == 2 for r in sh)


# -- (e) options: compact, stats, donation -----------------------------------

def test_mesh_requires_compact():
    insts = _grid(2)
    with pytest.raises(ValueError, match="compact"):
        teng.run_instances(insts, n_angles=N_ANGLES, max_epochs=2,
                           mesh=_mesh(2), compact=False, device="cpu")
    with pytest.raises(ValueError, match="compact"):
        tmm.run_instances(_grid(2, selector="maxmarg"), max_epochs=2,
                          mesh=_mesh(2), compact=False, device="cpu")
    data, s0, k, _ = teng.pack_instances(insts, n_angles=16, max_epochs=2,
                                         mesh=_mesh(2))
    V = torch.zeros((16, 2))
    with pytest.raises(ValueError, match="compact"):
        tmed.run_hot(data, V, s0, k=k, max_turns=4, mesh=_mesh(2),
                     compact=False)
    with pytest.raises(ValueError, match="divisible"):
        flat, f0, _, _ = teng.pack_instances(insts[:1], n_angles=16,
                                             max_epochs=2, device="cpu")
        tmed.run_hot(flat, V, f0, k=k, max_turns=4, mesh=_mesh(2))


def test_stats_equal_the_skew_of_the_recorded_counts(monkeypatch):
    """``stats`` holds ``shard_skew`` of the per-turn shard counts that
    ``balanced_index`` returned: the last, the largest and their number."""
    seen = []
    real = thot.balanced_index

    def recording(act, B, shards):
        idx, counts = real(act, B, shards)
        seen.append(counts.copy())
        return idx, counts

    monkeypatch.setattr(thot, "balanced_index", recording)
    stats = {}
    res = teng.run_sweep(_grid(12, noisy_every=5), mesh=_mesh(4),
                         n_angles=N_ANGLES, max_epochs=MAX_EPOCHS,
                         stats=stats, device="cpu")
    assert sum(r.converged for r in res) == 9
    skews = [thot.shard_skew(c) for c in seen]
    assert set(stats) == {"shard_skew_last", "shard_skew_max",
                          "shard_dispatches"}
    assert stats["shard_dispatches"] == len(seen) >= 2
    assert stats["shard_skew_last"] == skews[-1]
    assert stats["shard_skew_max"] == max(skews)
    assert 1.0 <= stats["shard_skew_last"] <= stats["shard_skew_max"] <= 4.0


def test_single_device_sweeps_take_stats_untouched():
    """Without a mesh ``stats`` is taken and left empty, as JAX does: the
    MEDIAN and MAXMARG buckets of ``run_sweep`` and the unified dispatch."""
    stats = {}
    insts = _grid(4) + _grid(2, selector="maxmarg")
    res = teng.run_sweep(insts, n_angles=64, max_epochs=4, steps=STEPS,
                         stats=stats, device="cpu")
    assert all(r.converged for r in res[:4]) and stats == {}
    mixed = [teng.ProtocolInstance(i.shards, i.eps, sel, seed=j)
             for j, (i, sel) in enumerate(zip(
                 _grid(3), ("median", "maxmarg", "sampling")))]
    res = tuni.run_instances(mixed, stats=stats, max_epochs=4, steps=STEPS,
                             n_angles=64, device="cpu")
    assert len(res) == 3 and stats == {}


@pytest.mark.parametrize("selector", ["median", "maxmarg"])
def test_donated_run_writes_into_the_callers_tensors(selector):
    """``donate=True``: every turn — full batch and gathered sub-batch —
    lands in the given state's own tensors (no new state is allocated),
    with the results of the copying run, bit for bit; sharded, each shard
    keeps its buffers (donation is off by default, also on a mesh)."""
    from repro_torch.core import geometry

    insts = _grid(6, selector=selector, noisy_every=4)
    if selector == "median":
        def pack(mesh=None):
            return teng.pack_instances(insts, n_angles=N_ANGLES,
                                       max_epochs=4, mesh=mesh, device="cpu")
        V = geometry.direction_grid(N_ANGLES, device="cpu")

        def run(d, s, k, **kw):
            return tmed.run_hot(d, V, s, k=k, max_turns=4 * k, **kw)
    else:
        def pack(mesh=None):
            return teng.pack_instances_maxmarg(insts, max_epochs=4,
                                               max_support=4, mesh=mesh,
                                               device="cpu")

        def run(d, s, k, **kw):
            return tmm.run_hot(d, s, k=k, max_turns=4 * k, steps=STEPS,
                               **kw)
    data, s0, k, _ = pack()
    copied = run(data, s0, k)
    assert int(s0.turn.max()) == 0                  # untouched
    assert not copied.done.all() and copied.done.any()
    ptrs = [t.data_ptr() for t in tstate._leaves(s0)]
    donated = run(data, s0, k, donate=True)
    assert [t.data_ptr() for t in tstate._leaves(donated)] == ptrs
    assert int(s0.turn.max()) > 0                   # written in place
    for a, b in zip(tstate._leaves(copied), tstate._leaves(donated)):
        assert torch.equal(a, b)
    mesh = _mesh(2)
    data_s, fresh, _, _ = pack(mesh)
    ptrs = [t.data_ptr() for p in fresh for t in tstate._leaves(p)]
    run(data_s, fresh, k, mesh=mesh, overlap=False)
    assert all(int(p.turn.max()) == 0 for p in fresh)   # not donated
    out = run(data_s, fresh, k, mesh=mesh, overlap=False, donate=True)
    assert [t.data_ptr() for p in out for t in tstate._leaves(p)] == ptrs
    final = tstate.unshard(out)
    for a, b in zip(tstate._leaves(final), tstate._leaves(copied)):
        assert torch.equal(a[:6], b[:6])


def test_mesh_record_is_a_plain_named_tuple():
    mesh = DataMesh((torch.device("cpu"),) * 3)
    assert mesh.shape == {"data": 3} and mesh == _mesh(3)
