"""The port's engine records and hot-loop helpers against the JAX package's.

Tolerance: exact everywhere — packing, capacities, comm lowering, width
buckets and the gather/scatter semantics are integer or copy operations.
"""

import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax.numpy as jnp

from repro import engine as jeng
from repro.core import datasets, geometry as jgeo
from repro.engine import hotloop as jhot, state as jstate

import torch

from repro_torch import engine as teng
from repro_torch.engine import hotloop as thot, state as tstate


def _instances(k, ragged):
    out = []
    for i, gen in enumerate((datasets.data1, datasets.data2, datasets.data3)):
        shards = gen(n_per_node=30 + 7 * i, k=k, seed=i)
        if ragged:
            shards = [(X[: len(X) - 3 * j], y[: len(y) - 3 * j])
                      for j, (X, y) in enumerate(shards)]
        out.append(jeng.ProtocolInstance(shards, (0.1, 0.05, 0.02)[i]))
    return out


def _leaves(state):
    out = {f: getattr(state, f) for f in state._fields if f != "comm"}
    out.update({f"comm.{f}": getattr(state.comm, f)
                for f in state.comm._fields})
    return out


@pytest.mark.parametrize("k,ragged", [(2, False), (2, True), (3, True)])
def test_pack_instances_every_leaf_equal(k, ragged):
    insts = _instances(k, ragged)
    jd, js, jk, jcap = jeng.pack_instances(insts, n_angles=64, max_epochs=6)
    td, ts, tk, tcap = teng.pack_instances(
        [teng.ProtocolInstance(i.shards, i.eps) for i in insts],
        n_angles=64, max_epochs=6, device="cpu")
    assert (jk, jcap) == (tk, tcap)
    for a, b in zip(jd, td):
        assert str(b.dtype).split(".")[-1] == str(np.asarray(a).dtype)
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    jl, tl = _leaves(js), _leaves(ts)
    assert list(jl) == list(tl)
    for name in jl:
        a, b = np.asarray(jl[name]), tl[name].numpy()
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(b, a, err_msg=name)


def test_from_reference_carries_every_leaf():
    insts = _instances(2, True)
    jd, js, _, _ = jeng.pack_instances(insts, n_angles=32, max_epochs=4)
    V = jgeo.direction_grid(32)
    td, ts, tV = teng.from_reference(jd, js, V, device="cpu")
    np.testing.assert_array_equal(tV.numpy(), np.asarray(V))
    for a, b in zip(jd, td):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    for name, a in _leaves(js).items():
        np.testing.assert_array_equal(_leaves(ts)[name].numpy(),
                                      np.asarray(a), err_msg=name)


def test_transcript_capacity_matches():
    for k in (2, 3, 5):
        for e in (1, 4, 16, 48):
            assert (tstate.transcript_capacity(k, e)
                    == jstate.transcript_capacity(k, e))


def test_comm_log_lowering_matches():
    rng = np.random.default_rng(0)
    cols = [rng.integers(0, 500, size=6).astype(np.int32) for _ in range(5)]
    jlog = jstate.BatchCommLog(*map(jnp.asarray, cols))
    tlog = tstate.BatchCommLog(*map(torch.from_numpy, cols))
    assert tlog.summaries(2) == jlog.summaries(2)
    assert tlog.summary(3, dim=5) == jlog.summary(3, dim=5)


def test_pack_instances_rejects_mixed_shapes():
    a = teng.ProtocolInstance(datasets.data1(n_per_node=10, k=2), 0.1)
    b = teng.ProtocolInstance(datasets.data1(n_per_node=10, k=3), 0.1)
    with pytest.raises(ValueError, match="party count"):
        teng.pack_instances([a, b], n_angles=8, max_epochs=2, device="cpu")
    c = teng.ProtocolInstance(datasets.data_highd(n_per_node=10, d=3), 0.1)
    with pytest.raises(ValueError, match="R\\^2"):
        teng.pack_instances([c], n_angles=8, max_epochs=2, device="cpu")


def test_quantize_width_matches():
    for cap in (64, 264):
        for w in range(0, cap + 12):
            assert thot.quantize_width(w, cap) == jhot.quantize_width(w, cap)


def test_gather_take_put_match_reference_fill_and_drop():
    """Pad indices (= B) gather zero rows and never land on scatter, as the
    JAX helpers' ``mode="fill"`` gather and dropping scatter do."""
    rng = np.random.default_rng(1)
    B = 7
    arrs = (rng.normal(size=(B, 3, 2)).astype(np.float32),
            rng.integers(-1, 2, size=(B, 3)).astype(np.int32),
            rng.random(B) < 0.5)
    idx = np.array([5, 1, 4, B, B, B], np.int32)
    n_act = 3
    jtree = jstate.EngineData(*map(jnp.asarray, arrs))
    ttree = tstate.EngineData(*map(torch.from_numpy, arrs))
    jsub = jhot.take_instances(jtree, jnp.asarray(idx))
    tsub = thot.take_instances(ttree, torch.from_numpy(idx).long(), n_act)
    for a, b in zip(jsub, tsub):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    # scatter back a modified sub-batch
    jnew = jstate.EngineData(*(a + 1 if a.dtype != jnp.bool_ else ~a
                               for a in jsub))
    tnew = tstate.EngineData(*(a + 1 if a.dtype != torch.bool else ~a
                               for a in tsub))
    jfull = jhot.put_instances(jtree, jnew, jnp.asarray(idx))
    tfull = thot.put_instances(thot.tree_map(torch.clone, ttree), tnew,
                               torch.from_numpy(idx).long(), n_act)
    for a, b in zip(jfull, tfull):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    ci = np.array([0, 2, 1, 1, 0, 2, 2], np.int32)
    np.testing.assert_array_equal(
        thot.gather_rows(ttree[0], torch.from_numpy(ci)).numpy(),
        np.asarray(jhot.gather_rows(jtree[0], jnp.asarray(ci))))
