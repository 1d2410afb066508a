"""Counter-based random numbers: the Threefry-2x32 generator of the JAX
package's ``jax.random``, in torch integer operations on the key's device.

The one-way SAMPLING selector draws its reservoir slots with
``jax.random.randint`` from per-instance keys (``repro.engine.oneway``).
These functions give the same bits as jax's defaults — the
``threefry2x32`` implementation with ``jax_threefry_partitionable`` on and
64-bit mode off — so a sampled reservoir is the reference's, row for row:

* :func:`prng_key` is ``jax.random.PRNGKey(seed)``: words ``(0, seed mod
  2**32)``;
* :func:`split` is ``jax.random.split(key, n)``;
* :func:`random_bits` is ``jax.random.bits`` for 32-bit words;
* :func:`randint` is ``jax.random.randint`` for int32 results, with
  per-element bounds.

Every uint32 word is held in an int64 tensor and masked back to 32 bits
after each addition and shift (torch has no general uint32 arithmetic).
A key is a (..., 2) tensor; a batch of keys draws one independent stream
per leading index, as a ``vmap`` over the keys does in JAX.
"""

from __future__ import annotations

import math
from typing import Sequence, Union

import torch

MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & MASK


def threefry2x32(k1, k2, x1, x2):
    """The Threefry-2x32 block function (20 rounds) on broadcastable int64
    tensors of uint32 words: key ``(k1, k2)``, counter ``(x1, x2)``.
    Returns the two output words."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x1 = (x1 + ks[0]) & MASK
    x2 = (x2 + ks[1]) & MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = (x1 + x2) & MASK
            x2 = x1 ^ _rotl(x2, r)
        x1 = (x1 + ks[(i + 1) % 3]) & MASK
        x2 = (x2 + ks[(i + 2) % 3] + (i + 1)) & MASK
    return x1, x2


def prng_key(seed: Union[int, Sequence[int]], device="cpu") -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` as an int64 (2,) tensor, or (B, 2) for a
    sequence of seeds: in 32-bit mode the seed's low word, after a zero."""
    seeds = torch.as_tensor(seed, dtype=torch.int64, device=device) & MASK
    return torch.stack([torch.zeros_like(seeds), seeds], dim=-1)


def _hash_iota(key: torch.Tensor, shape) -> tuple:
    """The partitionable layout: the block function of ``key`` (..., 2) on
    the 64-bit iota over ``shape``, split into (hi, lo) counter words.
    Returns two (..., *shape) tensors."""
    shape = tuple(shape)
    n = math.prod(shape)
    idx = torch.arange(n, dtype=torch.int64, device=key.device)
    lead = key.shape[:-1]
    k1 = key[..., 0].reshape(lead + (1,))
    k2 = key[..., 1].reshape(lead + (1,))
    b1, b2 = threefry2x32(k1, k2, idx >> 32, idx & MASK)
    return b1.reshape(lead + shape), b2.reshape(lead + shape)


def split(key: torch.Tensor, n: int = 2) -> torch.Tensor:
    """``jax.random.split(key, n)``: (..., 2) -> (..., n, 2)."""
    b1, b2 = _hash_iota(key, (n,))
    return torch.stack([b1, b2], dim=-1)


def random_bits(key: torch.Tensor, shape) -> torch.Tensor:
    """32 random bits per element, ``jax.random.bits(key, shape)``:
    (..., 2) -> (..., *shape) int64 words in [0, 2**32)."""
    b1, b2 = _hash_iota(key, shape)
    return b1 ^ b2


def randint(key: torch.Tensor, shape, minval, maxval) -> torch.Tensor:
    """``jax.random.randint(key, shape, minval, maxval)`` with int32
    results: (..., 2) keys -> (..., *shape), ``minval``/``maxval``
    broadcastable to that shape (one span per element).

    JAX draws two words per element from the two halves of a split and
    folds them into [minval, maxval) modulo the span in uint32 arithmetic,
    with ``multiplier = (2**16 mod span)**2 mod span`` (which wraps to 0
    for spans above 2**16); an empty range returns ``minval``.  Every
    product below stays under 2**33, so int64 holds it exactly."""
    halves = split(key, 2)
    hi = random_bits(halves[..., 0, :], shape)
    lo = random_bits(halves[..., 1, :], shape)
    minval = torch.as_tensor(minval, dtype=torch.int64, device=key.device)
    maxval = torch.as_tensor(maxval, dtype=torch.int64, device=key.device)
    span = torch.where(maxval <= minval, 1, (maxval - minval) & MASK)
    mult = torch.remainder(65536, span)
    mult = torch.remainder((mult * mult) & MASK, span)
    off = (((hi % span) * mult) & MASK) + (lo % span)
    off = (off & MASK) % span
    out = (minval + off) & MASK
    return torch.where(out > 0x7FFFFFFF, out - (1 << 32), out).to(torch.int32)
