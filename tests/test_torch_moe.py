"""The port's MoE FFN (``repro_torch.models.moe``) against the JAX package's
(``repro.models.moe``), on the CPU, at the reduced configs of grok-1 (no
shared expert) and DeepSeek-V2 (one shared expert; also two), 4 experts,
top-2, d_model 256, d_expert 128, in f32.

Tolerances: ``moe_capacity``, the expert ids, the capacity drops
(``keep``) and the buffer rows (``dest``) exact, the latter two against
JAX's own sort-based dispatch recomputed from JAX's top-k; gates atol
1e-6 (they lie in [0, 1]); outputs atol 1e-5; the aux loss rtol 1e-5.
Paths: the per-row dispatch (drop-free and, at B=1 S=512 with the router biased toward one
expert, with drops), the gather path (B·S <= 16), the decode reshape
(B0 tokens of one position dispatched as one row, to either path) and the
shared experts.  JAX's weights are carried across as numpy arrays.
"""

import dataclasses
import functools
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import repro.configs as JC  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402

from repro_torch import configs as TC  # noqa: E402
from repro_torch.models import moe  # noqa: E402

ARCHS = ["grok-1-314b", "deepseek-v2-236b", "deepseek-v2-236b/2-shared"]
# JAX's MoE compiled once a shape (the config static)
_jax_moe = jax.jit(jmoe.apply_moe, static_argnums=(1,))


def _configs(arch):
    name, _, variant = arch.partition("/")
    cfgs = [pkg.get_config(name).reduced() for pkg in (TC, JC)]
    if variant:
        cfgs = [dataclasses.replace(c, moe=dataclasses.replace(c.moe,
                                                               n_shared=2))
                for c in cfgs]
    return cfgs


_INIT = {}


def _params(arch, bias=0.0):
    """(port cfg, JAX cfg, JAX params, port params); ``bias`` is added to
    every router weight of expert 0."""
    cfg, jcfg = _configs(arch)
    if arch not in _INIT:
        _INIT[arch] = jax.tree.map(np.asarray, jax.jit(
            jmoe.init_moe, static_argnums=(1,))(jax.random.PRNGKey(4), jcfg))
    npp = {k: np.array(v) for k, v in _INIT[arch].items()}
    npp["router"][:, 0] += bias
    return (cfg, jcfg, {k: jnp.asarray(v) for k, v in npp.items()},
            {k: torch.from_numpy(v) for k, v in npp.items()})


def _x(shape, seed=0, shift=0.0):
    return (np.random.default_rng(seed).normal(size=shape) + shift).astype(
        np.float32)


@functools.partial(jax.jit, static_argnums=(1,))
def _jax_plan(jp, jcfg, x):
    """JAX's routing and dispatch plan, the lines of ``apply_moe`` that
    compute them, on JAX's own top-k."""
    mo = jcfg.moe
    B, S, _ = x.shape
    E, K = mo.n_experts, mo.top_k
    cap = jmoe.moe_capacity(jcfg, S)
    probs = jax.nn.softmax((x @ jp["router"]).astype(jnp.float32), axis=-1)
    gate_vals, expert_ids = jax.lax.top_k(probs, K)
    gate_vals = gate_vals / (gate_vals.sum(-1, keepdims=True) + 1e-9)
    flat_e = expert_ids.reshape(B, S * K)
    se = jnp.take_along_axis(flat_e, jnp.argsort(flat_e, axis=1), axis=1)
    seg_start = jax.vmap(lambda row: jnp.searchsorted(row, jnp.arange(E)))(se)
    pos_in_e = (jnp.arange(S * K)[None]
                - jnp.take_along_axis(seg_start, se, axis=1))
    keep = pos_in_e < cap
    dest = se * cap + jnp.where(keep, pos_in_e, 0)
    return gate_vals, expert_ids, keep, dest


def _check_route(arch, x, bias=0.0):
    cfg, jcfg, jp, tp = _params(arch, bias)
    r = moe.route(tp, cfg, torch.from_numpy(x))
    gate_vals, expert_ids, keep, dest = map(np.asarray, _jax_plan(
        jp, jcfg, jnp.asarray(x)))
    np.testing.assert_array_equal(r.expert_ids.numpy(), expert_ids)
    np.testing.assert_array_equal(r.keep.numpy(), keep)
    np.testing.assert_array_equal(r.dest.numpy(), dest)
    np.testing.assert_allclose(r.gate_vals.numpy(), gate_vals, rtol=0,
                               atol=1e-6)
    _, jaux = _jax_moe(jp, jcfg, jnp.asarray(x))
    np.testing.assert_allclose(float(r.aux), float(jaux), rtol=1e-5)
    return r


def _check_apply(arch, x, bias=0.0):
    cfg, jcfg, jp, tp = _params(arch, bias)
    out, aux = moe.apply_moe(tp, cfg, torch.from_numpy(x))
    jout, jaux = _jax_moe(jp, jcfg, jnp.asarray(x))
    assert out.shape == x.shape and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-5)
    return float(aux)


@pytest.mark.parametrize("n_tokens", [1, 8, 64, 128, 129, 200, 512, 2048])
@pytest.mark.parametrize("arch", ["grok-1-314b", "deepseek-v2-236b"])
def test_capacity_matches(arch, n_tokens):
    cfg, jcfg = _configs(arch)
    full = [pkg.get_config(arch) for pkg in (TC, JC)]
    assert moe.moe_capacity(cfg, n_tokens) == jmoe.moe_capacity(jcfg, n_tokens)
    assert (moe.moe_capacity(full[0], n_tokens)
            == jmoe.moe_capacity(full[1], n_tokens))


@pytest.mark.parametrize("arch", ARCHS)
def test_init_moe_leaves_match(arch):
    cfg, jcfg = _configs(arch)
    jp = jax.eval_shape(lambda key: jmoe.init_moe(key, jcfg),
                        jax.random.PRNGKey(0))
    tp = moe.init_moe(torch.Generator().manual_seed(0), cfg)
    assert {k: tuple(v.shape) for k, v in tp.items()} == {
        k: tuple(v.shape) for k, v in jp.items()}
    # JAX's scales: router 0.02, the rest 1/sqrt(fan-in)
    for k in tp:
        want = 0.02 if k == "router" else 1 / np.sqrt(tp[k].shape[-2])
        assert float(tp[k].std()) == pytest.approx(want, rel=0.05), k


@pytest.mark.parametrize("arch", ARCHS)
def test_route_matches_jax_dispatch(arch):
    r = _check_route(arch, _x((2, 32, 256), seed=1))
    assert bool(r.keep.all())         # S·K <= 256: drop-free capacity


@pytest.mark.parametrize("arch", ARCHS)
def test_dispatch_path_matches(arch):
    assert _check_apply(arch, _x((2, 32, 256), seed=2)) > 0


@pytest.mark.parametrize("arch", ARCHS)
def test_drops_match(arch):
    """B=1, S=512: capacity 320 a expert; the router biased toward expert
    0, which every token picks, so 192 of its slots are dropped (the
    latest tokens, as JAX's stable sort drops them), beside any other
    expert's overflow."""
    x = _x((1, 512, 256), seed=3, shift=1.0)
    r = _check_route(arch, x, bias=0.05)
    assert moe.moe_capacity(_configs(arch)[0], 512) == 320
    se = r.expert_ids.reshape(1, -1).gather(1, r.order)
    assert int((se == 0).sum()) == 512
    assert int((~r.keep & (se == 0)).sum()) == 512 - 320
    # expert 0's segment keeps its first 320 tokens
    kept_tokens = torch.div(r.order[se == 0], 2, rounding_mode="floor")
    assert kept_tokens.tolist() == list(range(512))
    assert r.keep[se == 0].tolist() == [True] * 320 + [False] * 192
    _check_apply(arch, x, bias=0.05)


@pytest.mark.parametrize("shape", [(2, 8), (1, 5), (1, 16)])
@pytest.mark.parametrize("arch", ARCHS)
def test_gather_path_matches(arch, shape):
    assert _check_apply(arch, _x(shape + (256,), seed=4)) == 0.0


@pytest.mark.parametrize("B0", [4, 16, 40])
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_reshape_matches(arch, B0):
    """(B0, 1, d) is dispatched as one row of B0 tokens: the gather path
    up to 16, the dispatch past it (aux from one row's means)."""
    aux = _check_apply(arch, _x((B0, 1, 256), seed=5))
    assert (aux == 0.0) == (B0 <= 16)


def test_shared_experts_count():
    """The shared experts add their SwiGLU: without them the output
    differs by exactly that term."""
    cfg, _, _, tp = _params("deepseek-v2-236b/2-shared")
    x = torch.from_numpy(_x((2, 32, 256), seed=6))
    with_shared, _ = moe.apply_moe(tp, cfg, x)
    bare = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                            n_shared=0))
    without, _ = moe.apply_moe(tp, bare, x)
    torch.testing.assert_close(with_shared - without, moe._shared(tp, x),
                               rtol=1e-5, atol=1e-5)
