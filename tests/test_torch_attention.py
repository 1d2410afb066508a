"""The port's attention family (``repro_torch.kernels.flash_attention``,
``repro_torch.models.layers`` attention) against the JAX package's, on the
CPU.

Tolerances: the plain version against JAX's dense oracle
``ref.attention_ref`` to 1e-5 in f32 (both dense softmaxes in f32, summed in
other orders); against JAX's flash kernel ``ops.attention`` in interpret
mode at JAX's own tier (2e-4 f32, 2e-2 bf16: an online softmax against a
dense one, and bf16 outputs); the attention layer's branches to
rtol 1e-5 / atol 1e-6 of the output's scale in f32 (see ``_close``).  Inputs come from numpy seeds; JAX weights
are carried across as numpy arrays.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import repro.configs as JC  # noqa: E402
from repro.kernels import ops as jops, ref as jref  # noqa: E402
from repro.models import layers as JL  # noqa: E402

from repro_torch import kernels  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402


def _qkv(seed, B, Sq, Skv, H, KV, hd):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, Sq, H, hd)).astype(np.float32),
            rng.normal(size=(B, Skv, KV, hd)).astype(np.float32),
            rng.normal(size=(B, Skv, KV, hd)).astype(np.float32))


# (B, Sq, Skv, H, KV, hd, causal, window, kv_valid): the shape grid of the
# JAX package's flash tests (MHA, GQA 4:1, MQA, H=6/KV=3 at hd 128), its
# windows and kv_valid case, ragged Sq (causal, and against a longer Skv)
CASES = [
    (1, 128, 128, 4, 4, 64, True, None, None),
    (2, 256, 256, 8, 2, 64, True, None, None),
    (1, 512, 512, 4, 1, 32, True, None, None),
    (2, 128, 128, 6, 3, 128, True, None, None),
    (1, 256, 256, 2, 2, 32, True, 32, None),
    (1, 256, 256, 2, 2, 32, True, 128, None),
    (2, 128, 256, 4, 4, 32, False, None, 100),
    (1, 100, 100, 4, 2, 32, True, None, None),
    (2, 100, 160, 6, 3, 64, False, None, None),
]
IDS = ["mha", "gqa4", "mqa", "h6kv3_hd128", "window32", "window128",
       "kv_valid100", "ragged_causal", "ragged_cross"]


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_plain_matches_dense_oracle(case):
    B, Sq, Skv, H, KV, hd, causal, window, kv_valid = case
    q, k, v = _qkv(sum(case[:6]), B, Sq, Skv, H, KV, hd)
    want = jref.attention_ref(q, k, v, causal=causal, window=window,
                              kv_valid=kv_valid)
    got = kernels.attention_plain(*map(torch.from_numpy, (q, k, v)),
                                  causal=causal, window=window,
                                  kv_valid=kv_valid)
    assert got.dtype == torch.float32 and got.shape == (B, Sq, H, hd)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", [CASES[i] for i in (0, 1, 3, 4, 6, 7)],
                         ids=[IDS[i] for i in (0, 1, 3, 4, 6, 7)])
def test_plain_matches_jax_flash_kernel(case, dtype):
    """Against the Pallas kernel itself, run in interpret mode through its
    wrapper (which pads ragged shapes), as the JAX package's tests run it."""
    B, Sq, Skv, H, KV, hd, causal, window, kv_valid = case
    q, k, v = _qkv(7 + sum(case[:6]), B, Sq, Skv, H, KV, hd)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    want = jops.attention(*(jnp.asarray(a, jdt) for a in (q, k, v)),
                          causal=causal, window=window, kv_valid=kv_valid,
                          interpret=True)
    got = kernels.attention_plain(
        *(torch.from_numpy(a).to(tdt) for a in (q, k, v)), causal=causal,
        window=window, kv_valid=kv_valid)
    assert got.dtype == tdt
    tol = 2e-2 if dtype == "bfloat16" else 2e-4
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


def test_fully_masked_rows_are_zero():
    q, k, v = map(torch.from_numpy, _qkv(3, 1, 8, 8, 2, 2, 32))
    out = kernels.attention_plain(q, k, v, causal=False, kv_valid=0)
    assert torch.equal(out, torch.zeros_like(out))
    want = jref.attention_ref(q.numpy(), k.numpy(), v.numpy(), causal=False,
                              kv_valid=0)
    assert not np.asarray(want).any()


def test_wrapper_takes_plain_version_on_cpu_without_launching():
    q, k, v = map(torch.from_numpy, _qkv(5, 2, 100, 100, 4, 2, 64))
    kernels.reset_launches()
    for kw in (dict(causal=True), dict(causal=True, window=16),
               dict(causal=False, kv_valid=37)):
        assert torch.equal(kernels.attention(q, k, v, **kw),
                           kernels.attention_plain(q, k, v, **kw))
    assert kernels.attention.launches == 0
    assert kernels.launches()["attention"] == 0


# -- the kernel routes ----------------------------------------------------

@pytest.mark.parametrize("Sq", [1, 4, 16, 17, 1500])
@pytest.mark.parametrize("hd", [32, 64, 128, 256])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
def test_attention_route(dtype, hd, Sq):
    """Up to 16 query rows split the keys whatever the dtype and width;
    above that bf16 at hd 64 or 128 takes the tensor cores and everything
    else, f32 included, the CUDA cores."""
    if Sq <= 16:
        want = "splitkv"
    elif dtype == torch.bfloat16 and hd in (64, 128):
        want = "tc"
    else:
        want = "simt"
    assert kernels.flash_attention.attention_route(dtype, hd, Sq, 1500) \
        == want
    assert kernels.flash_attention.attention_route(dtype, hd, Sq, 1) == want


# (what, dtype, hd, Sq, Skv, route): the calls the token paths make under
# the kernel backend, and the f32 card-against-CPU checks
PATH_CALLS = [
    ("smollm-135m scoring", torch.bfloat16, 64, 2048, 2048, "tc"),
    ("whisper-medium encoder", torch.bfloat16, 64, 1500, 1500, "tc"),
    ("whisper-medium cross-attention at prefill", torch.bfloat16, 64, 4,
     1500, "splitkv"),
    ("whisper-medium cross-attention at decode", torch.bfloat16, 64, 1,
     1500, "splitkv"),
    ("Jamba scoring", torch.bfloat16, 128, 2048, 2048, "tc"),
    ("qwen2.5-14b heads", torch.bfloat16, 128, 1024, 1024, "tc"),
    ("smollm-135m card vs cpu, f32", torch.float32, 64, 128, 128, "simt"),
    ("whisper-medium decode, f32", torch.float32, 64, 1, 256, "splitkv"),
]


@pytest.mark.parametrize("call", PATH_CALLS, ids=[c[0] for c in PATH_CALLS])
def test_paths_take_their_routes(call):
    _, dtype, hd, Sq, Skv, route = call
    assert kernels.flash_attention.attention_route(dtype, hd, Sq, Skv) == route


def test_routes_are_counted_and_reset_with_the_launches():
    """Every route has its source; ``reset_launches`` clears the per-route
    counts with the launch counts, and CPU calls count neither."""
    fa = kernels.flash_attention
    assert set(fa.attention.routes) == set(fa.ROUTES)
    for route, stem in fa._STEM.items():
        assert (kernels._build.CSRC / f"{stem}.cu").exists(), route
    fa.attention.routes["tc"] = 3
    kernels.reset_launches()
    assert fa.attention.routes == dict.fromkeys(fa.ROUTES, 0)
    q, k, v = map(torch.from_numpy, _qkv(6, 1, 4, 40, 4, 2, 64))
    kernels.attention(q, k, v, causal=False)
    assert fa.attention.routes == dict.fromkeys(fa.ROUTES, 0)
    src = (kernels._build.CSRC / "flash_attention_splitkv.cu").read_text()
    assert "return 8192 / HD;" in src and fa.split_keys(64) == 8192 // 64


# -- the attention layer --------------------------------------------------

def _cfg(arch="qwen2.5-14b"):
    return get_config(arch).reduced(), JC.get_config(arch).reduced()


def _layer_params(jcfg, seed=0):
    """JAX ``init_attention`` weights with nonzero biases, as numpy."""
    p = jax.tree.map(np.asarray,
                     JL.init_attention(jax.random.PRNGKey(seed), jcfg))
    rng = np.random.default_rng(seed)
    return {k: (rng.normal(0, 0.5, a.shape).astype(np.float32)
                if k.startswith("b") else a) for k, a in p.items()}


def _t(tree):
    return {k: torch.from_numpy(np.array(a)) for k, a in tree.items()}


def _close(got, want):
    """rtol 1e-5, atol 1e-6 of the output's scale: the products over
    d_model = 256 round in another order in XLA and in PyTorch, a few ulps
    of the largest terms, which shows on entries near 0."""
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                               atol=1e-6 * max(1.0, float(np.abs(want).max())))


@pytest.fixture
def impls():
    """Select a backend pair for one test; the defaults come back after."""
    def select(jax_impl, port_impl):
        JL.set_attention_impl(jax_impl)
        L.set_attention_impl(port_impl)
    yield select
    JL.set_attention_impl("xla")
    L.set_attention_impl("plain")


@pytest.mark.parametrize("backends", [("xla", "plain"), ("pallas", "kernel")])
@pytest.mark.parametrize("causal", [True, False])
def test_self_attention_matches(backends, causal, impls):
    impls(*backends)
    cfg, jcfg = _cfg()
    p = _layer_params(jcfg)
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 24, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(24)[None], (2, 24)).astype(np.int32)
    want, _ = JL.apply_attention(p, jcfg, jnp.asarray(x), jnp.asarray(pos),
                                 causal=causal)
    got, cache = L.apply_attention(_t(p), cfg, torch.from_numpy(x),
                                   torch.from_numpy(pos), causal=causal)
    assert cache is None
    _close(got, want)


def test_attention_core_block_pass_matches():
    """Several query blocks (block_q < Sq) give the one-block result."""
    q, k, v = map(torch.from_numpy, _qkv(9, 1, 64, 64, 4, 2, 32))
    whole = L.attention_core(q, k, v, causal=True)
    blocks = L.attention_core(q, k, v, causal=True, block_q=16)
    torch.testing.assert_close(blocks, whole, rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError, match="multiple"):
        L.attention_core(q, k, v, causal=True, block_q=24)


@pytest.mark.parametrize("window", [None, 8])
def test_cached_decode_matches(window):
    """Prefill 4 tokens into a cache at index 0, then decode 6 tokens one
    at a time; under a window of 8 the cache is a ring buffer and the
    decode runs past its length."""
    cfg, jcfg = _cfg()
    p = _layer_params(jcfg, seed=2)
    B, S0, steps = 2, 4, 6
    Sc = window if window is not None else S0 + steps
    rng = np.random.default_rng(3)
    x = rng.normal(size=(B, S0 + steps, cfg.d_model)).astype(np.float32)
    shape = (B, Sc, cfg.n_kv, cfg.hd)
    jc = {"k": jnp.zeros(shape), "v": jnp.zeros(shape)}
    tc = {"k": torch.zeros(shape), "v": torch.zeros(shape)}
    tp = _t(p)
    for t0, S in [(0, S0)] + [(S0 + i, 1) for i in range(steps)]:
        pos = np.broadcast_to(np.arange(t0, t0 + S)[None], (B, S))
        xs = x[:, t0:t0 + S]
        want, jc = JL.apply_attention(
            p, jcfg, jnp.asarray(xs), jnp.asarray(pos), window=window,
            cache=jc, cache_index=jnp.int32(t0))
        got, out_cache = L.apply_attention(
            tp, cfg, torch.from_numpy(xs), torch.from_numpy(pos.copy()),
            window=window, cache=tc, cache_index=t0)
        assert out_cache is tc          # written in place
        _close(got, want)
        _close(tc["k"], jc["k"])
        _close(tc["v"], jc["v"])


@pytest.mark.parametrize("backends", [("xla", "plain"), ("pallas", "kernel")])
def test_cross_attention_and_kv_override_match(backends, impls):
    impls(*backends)
    cfg, jcfg = _cfg("whisper-medium")
    p = _layer_params(jcfg, seed=4)
    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, 3, cfg.d_model)).astype(np.float32)
    y = rng.normal(size=(2, 40, cfg.d_model)).astype(np.float32)
    pos = np.zeros((2, 3), np.int32)
    want, jkv = JL.apply_attention(p, jcfg, jnp.asarray(x), jnp.asarray(pos),
                                   cross_y=jnp.asarray(y))
    got, tkv = L.apply_attention(_t(p), cfg, torch.from_numpy(x),
                                 torch.from_numpy(pos),
                                 cross_y=torch.from_numpy(y))
    _close(got, want)
    _close(tkv["k"], jkv["k"])
    _close(tkv["v"], jkv["v"])
    want, _ = JL.apply_attention(p, jcfg, jnp.asarray(x[:, :1]),
                                 jnp.asarray(pos[:, :1]),
                                 kv_override=(jkv["k"], jkv["v"]))
    got, none = L.apply_attention(_t(p), cfg, torch.from_numpy(x[:, :1]),
                                  torch.from_numpy(pos[:, :1]),
                                  kv_override=(tkv["k"], tkv["v"]))
    assert none is None
    _close(got, want)


@pytest.mark.parametrize("name", ["xla", "pallas"])
def test_set_attention_impl_takes_the_ports_names(name):
    with pytest.raises(ValueError, match="'plain' or 'kernel'"):
        L.set_attention_impl(name)
