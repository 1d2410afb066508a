"""The port's bulk scans over sweep state (``repro_torch.engine.dataplane``
``ranges`` / ``uncertain`` and the kernels' plain versions) against the
JAX package on the CPU.

The CUDA kernels run only on the card, where ``chip_smoke.py`` holds them
against these plain versions exactly.  Here:

* the plain versions against JAX's jnp twins
  (``ref.threshold_ranges_batch_ref`` / ``uncertain_mask_batch_ref``) and
  against the Pallas kernels in interpret mode, batched and single-instance:
  ranges with equal finite masks and finite values to rtol 1e-6 (the
  twins project with a dot, the port with one rounding per operation);
  masks exact, on random inputs whose bounds are drawn apart from the
  projections;
* the port's rescan against the ranges the port's MEDIAN engine keeps at
  append time: bit for bit (both take maxima of the same projections) —
  stronger than the JAX package's 1-ulp bar between its own two paths
  (tests/test_engine.py);
* padding rows inert; the B=1 forms equal to the batched form.
"""

import contextlib
import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from repro.kernels import ops, ref

import torch

from repro_torch import engine as teng, kernels
from repro_torch.core import datasets, geometry as tgeo
from repro_torch.engine import dataplane, median as tmed

RTOL = 1e-6


def _interpret_ctx():
    if hasattr(pltpu, "force_tpu_interpret_mode"):
        return pltpu.force_tpu_interpret_mode()
    return contextlib.nullcontext()


def _inputs(seed, B=4, m=48, n=40, d=2):
    """Shared directions, padded shards and per-instance bounds drawn apart
    from the projections; a class absent in one instance, one instance of
    padding only, some directions disallowed, ±inf bounds."""
    rng = np.random.default_rng(seed)
    V = rng.normal(size=(m, d))
    V = (V / np.linalg.norm(V, axis=1, keepdims=True)).astype(np.float32)
    X = rng.normal(size=(B, n, d)).astype(np.float32)
    y = rng.choice([-1, 1], size=(B, n)).astype(np.int32)
    y[:, -6:] = 0                                   # padding rows
    y[1 % B] = np.where(y[1 % B] == 1, -1, y[1 % B])   # no positives
    y[2 % B] = 0                                    # padding only
    dir_ok = rng.random((B, m)) < 0.7
    c = rng.normal(scale=0.5, size=(B, m)).astype(np.float32)
    w = rng.uniform(-0.5, 1.5, size=(B, m)).astype(np.float32)
    lo, hi = c - w / 2, c + w / 2                   # some intervals empty
    lo[:, ::7] = -np.inf
    hi[:, ::5] = np.inf
    return V, dir_ok, lo, hi, X, y


def _t(*arrays):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in arrays)


def _assert_ranges(got, want):
    for g, w in zip(got, want):
        g, w = g.numpy(), np.asarray(w)
        fin = np.isfinite(w)
        np.testing.assert_array_equal(np.isfinite(g), fin)
        np.testing.assert_array_equal(g[~fin], w[~fin])
        np.testing.assert_allclose(g[fin], w[fin], rtol=RTOL)


# -- plain versions against the JAX package ---------------------------------

@pytest.mark.parametrize("seed,d", [(0, 2), (1, 2), (2, 3), (3, 5)])
def test_ranges_plain_matches_jnp_twin(seed, d):
    V, _ok, _lo, _hi, X, y = _inputs(seed, d=d)
    want = ref.threshold_ranges_batch_ref(jnp.asarray(V), jnp.asarray(X),
                                          jnp.asarray(y))
    _assert_ranges(kernels.threshold_ranges_plain(*_t(V, X, y)), want)


@pytest.mark.parametrize("seed,d", [(0, 2), (1, 2), (2, 3), (3, 5)])
def test_uncertain_plain_matches_jnp_twin(seed, d):
    V, ok, lo, hi, X, y = _inputs(seed, d=d)
    want = ref.uncertain_mask_batch_ref(*map(jnp.asarray,
                                             (V, ok, lo, hi, X, y)))
    got = kernels.uncertain_mask_plain(*_t(V, ok, lo, hi, X, y))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("d", [2, 3])
def test_plain_versions_match_pallas_kernels_in_interpret_mode(d):
    """``threshold_ranges_batched`` / ``uncertain_mask_batched`` through the
    JAX package's wrappers, as tests/test_kernels_interpret.py runs them."""
    V, ok, lo, hi, X, y = _inputs(4, B=3, m=32, n=24, d=d)
    with _interpret_ctx():
        r_lo, r_hi = ops.support_ranges_batch(jnp.asarray(V), jnp.asarray(X),
                                              jnp.asarray(y), interpret=True)
        mask = ops.support_uncertain_batch(
            *map(jnp.asarray, (V, ok, lo, hi, X, y)), interpret=True)
    # the Pallas kernel keeps ±1e30 sentinels; dataplane.ranges maps them
    want = (np.where(np.asarray(r_lo) <= -5e29, -np.inf, r_lo),
            np.where(np.asarray(r_hi) >= 5e29, np.inf, r_hi))
    _assert_ranges(kernels.threshold_ranges_plain(*_t(V, X, y)), want)
    np.testing.assert_array_equal(
        kernels.uncertain_mask_plain(*_t(V, ok, lo, hi, X, y)).numpy(),
        np.asarray(mask))


def test_single_instance_forms_match_pallas_kernels_in_interpret_mode():
    """The single-instance TPU kernels ``threshold_ranges`` and
    ``uncertain_mask`` against the port's B=1 forms."""
    V, ok, lo, hi, X, y = _inputs(5, B=3, m=32, n=24)
    with _interpret_ctx():
        for b in range(3):
            r = ops.support_ranges(jnp.asarray(V), jnp.asarray(X[b]),
                                   jnp.asarray(y[b]), interpret=True)
            want = (np.where(np.asarray(r[0]) <= -5e29, -np.inf, r[0]),
                    np.where(np.asarray(r[1]) >= 5e29, np.inf, r[1]))
            got = kernels.threshold_ranges_one(*_t(V, X[b], y[b]))
            _assert_ranges(got, want)
            m = ops.support_uncertain(
                *map(jnp.asarray, (V, ok[b], lo[b], hi[b], X[b], y[b])),
                interpret=True)
            np.testing.assert_array_equal(
                kernels.uncertain_mask_one(
                    *_t(V, ok[b], lo[b], hi[b], X[b], y[b])).numpy(),
                np.asarray(m))


def test_b1_forms_equal_the_batched_form():
    V, ok, lo, hi, X, y = _t(*_inputs(6))
    lo_b, hi_b = kernels.threshold_ranges(V, X, y)
    mask_b = kernels.uncertain_mask(V, ok, lo, hi, X, y)
    for b in range(X.shape[0]):
        lo1, hi1 = kernels.threshold_ranges_one(V, X[b], y[b])
        assert torch.equal(lo1, lo_b[b]) and torch.equal(hi1, hi_b[b])
        assert torch.equal(kernels.uncertain_mask_one(
            V, ok[b], lo[b], hi[b], X[b], y[b]), mask_b[b])


def test_plain_chunking_changes_nothing(monkeypatch):
    from repro_torch.kernels import median_cut
    args = _t(*_inputs(7, B=9))
    V, ok, lo, hi, X, y = args
    whole = (kernels.threshold_ranges_plain(V, X, y),
             kernels.uncertain_mask_plain(*args))
    monkeypatch.setattr(median_cut, "_PLAIN_CHUNK", 2 * 48 * 40)
    chunked = (kernels.threshold_ranges_plain(V, X, y),
               kernels.uncertain_mask_plain(*args))
    for a, b in zip(whole[0], chunked[0]):
        assert torch.equal(a, b)
    assert torch.equal(whole[1], chunked[1])


def test_absent_classes_and_empty_transcripts_give_infinite_bounds():
    V, _ok, _lo, _hi, X, y = _t(*_inputs(8))
    lo, hi = dataplane.ranges(V, X, y)
    assert torch.isinf(lo[1]).all() and (lo[1] < 0).all()    # no positives
    assert torch.isinf(lo[2]).all() and torch.isinf(hi[2]).all()
    assert (hi[2] > 0).all()
    lo0, hi0 = dataplane.ranges(V, X[:, :0], y[:, :0])
    assert lo0.shape == (4, V.shape[0])
    assert (lo0 == -np.inf).all() and (hi0 == np.inf).all()


def test_uncertain_matches_the_single_instance_scans_on_live_rows():
    """``dataplane.uncertain`` over a padded transcript's ranges equals the
    single-instance scans over its live rows only, instance by instance:
    label-0 rows constrain nothing and are never reported."""
    V, ok, _lo, _hi, X, y = _t(*_inputs(9))
    lo, hi = dataplane.ranges(V, X, y)
    mask = dataplane.uncertain(V, ok, lo, hi, X, y)
    for b in range(X.shape[0]):
        live = y[b] != 0
        lo1, hi1 = kernels.threshold_ranges_one(V, X[b][live], y[b][live])
        want = kernels.uncertain_mask_one(V, ok[b], lo1, hi1, X[b], y[b])
        assert torch.equal(mask[b], want & live)


# -- the rescan oracle on the port's MEDIAN engine ---------------------------

MAX_EPOCHS = 6


def _median_final(n_angles=64, B=6):
    gens = (datasets.data1, datasets.data2, datasets.data3)
    insts = []
    for i in range(B):
        shards = gens[i % 3](n_per_node=40, k=2, seed=i)
        if i == 1:                            # ragged: label-0 padding rows
            shards = [(Xs[:33], ys[:33]) for Xs, ys in shards]
        eps = (0.1, 0.05)[i % 2]
        if i % 3 == 0:
            shards = datasets.add_label_noise(shards, 0.1, seed=i)
            eps = 0.02
        insts.append(teng.ProtocolInstance(shards, eps))
    data, s0, k, _cap = teng.pack_instances(insts, n_angles=n_angles,
                                            max_epochs=MAX_EPOCHS,
                                            device="cpu")
    V = tgeo.direction_grid(n_angles, device="cpu")
    final = tmed.run_compiled(data, V, s0, k=k, max_turns=k * MAX_EPOCHS)
    return data, s0, final, V, k


def test_incremental_ranges_equal_the_rescan_bit_for_bit():
    """Port twin of tests/test_engine.py's rescan test: each node's running
    (lo, hi) after a whole sweep equals a rescan of its final transcript."""
    _data, _s0, final, V, k = _median_final()
    assert int(final.w_fill.max()) > 0
    for j in range(k):
        lo, hi = dataplane.ranges(V, final.wx[:, j], final.wy[:, j])
        assert torch.equal(lo, final.lo_w[:, j])
        assert torch.equal(hi, final.hi_w[:, j])


def test_sou_padding_rows_inert():
    """Port twin of tests/test_engine.py's padding test: on an empty
    transcript every real point is uncertain and no padding row is."""
    data, s0, _final, V, _k = _median_final()
    lo, hi = dataplane.ranges(V, s0.wx[:, 0], s0.wy[:, 0])
    mask = dataplane.uncertain(V, s0.dir_ok, lo, hi, data.X[:, 0],
                               data.y[:, 0])
    assert torch.equal(mask, data.y[:, 0] != 0)
    assert (data.y[:, 0] == 0).any()


def test_sou_shrinks_over_the_sweep():
    """On the final state no padding row is uncertain, and the transcripts
    have taken points out of the SOU, which starts as every live point."""
    data, _s0, final, V, k = _median_final()
    for j in range(k):
        lo, hi = dataplane.ranges(V, final.wx[:, j], final.wy[:, j])
        mask = dataplane.uncertain(V, final.dir_ok, lo, hi, data.X[:, j],
                                   data.y[:, j])
        live = data.y[:, j] != 0
        assert not (mask & ~live).any()
        assert int(mask.sum()) < int(live.sum())
