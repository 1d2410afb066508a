"""The port's Threefry-2x32 generator (``repro_torch.core.prng``) against
``jax.random`` on the CPU.

Tolerance: none — every key, split, word and integer must be bit-equal to
jax's defaults (``threefry2x32`` with ``jax_threefry_partitionable`` on,
64-bit mode off), over eight seeds.  The one-way SAMPLING selector is
sample-exact against the JAX package only if these are.
"""

import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp

import torch

from repro_torch.core import prng

SEEDS = list(range(8))
SPANS = [1, 2, 3, 7, 1000, 65536, 65537, 100003, 2 ** 31 - 1]


def _words(a) -> np.ndarray:
    return np.asarray(a).astype(np.int64)


def test_jax_defaults_are_the_ones_ported():
    assert jax.config.jax_default_prng_impl == "threefry2x32"
    assert jax.config.jax_threefry_partitionable


@pytest.mark.parametrize("seed", SEEDS + [2 ** 31 - 1, -1, 2 ** 32 + 5])
def test_prng_key(seed):
    np.testing.assert_array_equal(prng.prng_key(seed).numpy(),
                                  _words(jax.random.PRNGKey(seed)))


def test_prng_key_batch():
    want = np.stack([_words(jax.random.PRNGKey(s)) for s in SEEDS])
    np.testing.assert_array_equal(prng.prng_key(SEEDS).numpy(), want)


@pytest.mark.parametrize("n", [1, 2, 3, 4, 5])
def test_split(n):
    for seed in SEEDS:
        np.testing.assert_array_equal(
            prng.split(prng.prng_key(seed), n).numpy(),
            _words(jax.random.split(jax.random.PRNGKey(seed), n)))


def test_split_of_a_batch_is_the_vmapped_split():
    """The hop keys of ``repro.engine.oneway._run_sampling``."""
    keys = jnp.stack([jax.random.PRNGKey(s) for s in SEEDS])
    want = jax.vmap(lambda kk: jax.random.split(kk, 3))(keys)
    np.testing.assert_array_equal(
        prng.split(prng.prng_key(SEEDS), 3).numpy(), _words(want))


@pytest.mark.parametrize("shape", [(1,), (5,), (3, 7), (2, 3, 4)])
def test_random_bits(shape):
    for seed in SEEDS:
        key = jax.random.PRNGKey(seed)
        np.testing.assert_array_equal(
            prng.random_bits(prng.prng_key(seed), shape).numpy(),
            _words(jax.random.bits(key, shape, jnp.uint32)))


@pytest.mark.parametrize("span", SPANS)
def test_randint_scalar_span(span):
    for seed in SEEDS:
        got = prng.randint(prng.prng_key(seed), (64,), 0, span)
        want = jax.random.randint(jax.random.PRNGKey(seed), (64,), 0, span)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_randint_per_element_maxval_as_the_reservoir_draws():
    """``randint(key, (n,), 0, maximum(t, 1))`` with one span per element,
    vmapped over a batch of keys (``oneway._make_ingest``)."""
    rng = np.random.default_rng(0)
    t = rng.integers(-3, 2 ** 31 - 1, size=(len(SEEDS), 40)).astype(np.int32)
    t[:, :8] = np.arange(8)                      # spans 0..7, 0 clamps to 1
    keys = jnp.stack([jax.random.PRNGKey(s) for s in SEEDS])
    want = jax.vmap(lambda kk, tt: jax.random.randint(
        kk, (40,), 0, jnp.maximum(tt, 1)))(keys, jnp.asarray(t))
    got = prng.randint(prng.prng_key(SEEDS), (40,), 0,
                       torch.clamp(torch.from_numpy(t), min=1))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_randint_nonzero_minval_and_empty_ranges():
    rng = np.random.default_rng(1)
    lo = rng.integers(-50, 50, size=30).astype(np.int32)
    hi = (lo + rng.integers(-3, 200, size=30)).astype(np.int32)
    for seed in SEEDS:
        want = jax.random.randint(jax.random.PRNGKey(seed), (30,),
                                  jnp.asarray(lo), jnp.asarray(hi))
        got = prng.randint(prng.prng_key(seed), (30,), torch.from_numpy(lo),
                           torch.from_numpy(hi))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
