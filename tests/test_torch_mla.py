"""The port's MLA (``repro_torch.models.layers.init_mla`` / ``apply_mla``)
against the JAX package's, on the CPU, at DeepSeek-V2's reduced config
(d_model 256, 4 heads, kv_lora 64, q_lora 1536, qk 32 nope + 16 rope, v
32) and its variant without the q-LoRA branch, in f32.

Tolerances: outputs rtol 1e-5 with atol 1e-6 of the output's scale, the
caches' latents and rope keys likewise, for the scoring pass (no cache),
a prefill into a cache and decode steps after it, and the sliding-window
ring (``cache_index mod Sc``, non-causal); the absorbed decode against
JAX's absorbed decode atol 1e-4, and against the port's faithful path
2e-3, JAX's own tier for the two paths (``tests/test_mla_absorb.py``).
JAX's weights are carried across as numpy arrays, the norm scales drawn
away from 1.
"""

import dataclasses
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import repro.configs as JC  # noqa: E402
from repro.models import layers as JL  # noqa: E402

from repro_torch import configs as TC  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402

VARIANTS = ["q_lora", "no_q_lora"]
# JAX's MLA compiled once a shape (the config, window and absorb static)
_jax_mla = jax.jit(JL.apply_mla, static_argnums=(1,),
                   static_argnames=("window", "absorb"))


def _configs(variant):
    cfgs = [pkg.get_config("deepseek-v2-236b").reduced() for pkg in (TC, JC)]
    if variant == "no_q_lora":
        cfgs = [dataclasses.replace(c, mla=dataclasses.replace(c.mla,
                                                               q_lora=None))
                for c in cfgs]
    return cfgs


def _params(variant):
    cfg, jcfg = _configs(variant)
    rng = np.random.default_rng(7)
    npp = {k: np.array(v) for k, v in jax.tree.map(np.asarray, jax.jit(
        JL.init_mla, static_argnums=(1,))(jax.random.PRNGKey(5), jcfg)).items()}
    for k in ("q_norm", "kv_norm"):
        if k in npp:
            npp[k] = (1 + rng.normal(0, 0.1, npp[k].shape)).astype(np.float32)
    return (cfg, jcfg, {k: jnp.asarray(v) for k, v in npp.items()},
            {k: torch.from_numpy(v) for k, v in npp.items()})


def _x(B, S, seed):
    return np.random.default_rng(seed).normal(size=(B, S, 256)).astype(
        np.float32)


def _pos(B, S, start=0):
    return np.broadcast_to(np.arange(start, start + S)[None], (B, S)).astype(
        np.int32)


def _close(got, want, **tol):
    want = np.asarray(want)
    tol = tol or dict(rtol=1e-5,
                      atol=1e-6 * max(1.0, float(np.abs(want).max())))
    np.testing.assert_allclose(got.float().numpy(), want, **tol)


def _caches(cfg, B, Sc):
    m = cfg.mla
    return ({"ckv": jnp.zeros((B, Sc, m.kv_lora)),
             "krope": jnp.zeros((B, Sc, m.qk_rope_dim))},
            {"ckv": torch.zeros((B, Sc, m.kv_lora)),
             "krope": torch.zeros((B, Sc, m.qk_rope_dim))})


def _run(cfg, jcfg, jp, tp, B, S, Sc, steps, window=None, absorb=False):
    """Prefill S positions into a cache of Sc, then decode ``steps``
    tokens; every output and the caches compared after each call.
    Returns the port's decode outputs."""
    jc, tc = _caches(cfg, B, Sc)
    x = _x(B, S + steps, seed=11)
    outs = []
    for i, (s0, n) in enumerate([(0, S)] + [(S + t, 1) for t in range(steps)]):
        xs, pos = x[:, s0:s0 + n], _pos(B, n, s0)
        flag = absorb and i > 0
        jo, jc = _jax_mla(jp, jcfg, jnp.asarray(xs), jnp.asarray(pos),
                          window=window, cache=jc,
                          cache_index=jnp.int32(s0), absorb=flag)
        to, tc2 = L.apply_mla(tp, cfg, torch.from_numpy(xs),
                              torch.from_numpy(pos), window=window, cache=tc,
                              cache_index=s0, absorb=flag)
        assert tc2 is tc
        if flag:
            _close(to, jo, rtol=0, atol=1e-4)
        else:
            _close(to, jo)
        for k in ("ckv", "krope"):
            _close(tc[k], jc[k])
        if i:
            outs.append(to)
    return outs


@pytest.mark.parametrize("variant", VARIANTS)
def test_init_mla_leaves_match(variant):
    cfg, jcfg = _configs(variant)
    jp = jax.eval_shape(lambda key: JL.init_mla(key, jcfg),
                        jax.random.PRNGKey(0))
    tp = L.init_mla(torch.Generator().manual_seed(0), cfg)
    assert {k: tuple(v.shape) for k, v in tp.items()} == {
        k: tuple(v.shape) for k, v in jp.items()}
    assert ("wdq" in tp) == (variant == "q_lora")


@pytest.mark.parametrize("variant", VARIANTS)
def test_scoring_pass_matches(variant):
    cfg, jcfg, jp, tp = _params(variant)
    x, pos = _x(2, 24, seed=1), _pos(2, 24)
    jo, jc = _jax_mla(jp, jcfg, jnp.asarray(x), jnp.asarray(pos))
    to, tc = L.apply_mla(tp, cfg, torch.from_numpy(x), torch.from_numpy(pos))
    assert jc is None and tc is None
    _close(to, jo)


@pytest.mark.parametrize("variant", VARIANTS)
def test_prefill_and_decode_match(variant):
    cfg, jcfg, jp, tp = _params(variant)
    _run(cfg, jcfg, jp, tp, B=2, S=12, Sc=16, steps=4)


def test_windowed_ring_matches():
    """Cache of 8 under window 8: prefill 8 positions, then 5 decode steps
    wrap to ring slots 0-4, attended without a causal mask."""
    cfg, jcfg, jp, tp = _params("q_lora")
    _run(cfg, jcfg, jp, tp, B=2, S=8, Sc=8, steps=5, window=8)


@pytest.mark.parametrize("variant", VARIANTS)
def test_absorbed_decode_matches(variant):
    """The latent-space decode against JAX's (1e-4) and against the port's
    faithful decode on the same caches (2e-3)."""
    cfg, jcfg, jp, tp = _params(variant)
    absorbed = _run(cfg, jcfg, jp, tp, B=2, S=12, Sc=16, steps=4,
                    absorb=True)
    faithful = _run(cfg, jcfg, jp, tp, B=2, S=12, Sc=16, steps=4)
    for a, f in zip(absorbed, faithful):
        torch.testing.assert_close(a, f, rtol=2e-3, atol=2e-3)


def test_reconstruct_path_keeps_off_the_flash_kernel(monkeypatch):
    """MLA passes an explicit scale (and K is wider than V), so the
    ``"kernel"`` backend never routes it to the flash wrapper."""
    from repro_torch.kernels import flash_attention as fa
    calls = []
    monkeypatch.setattr(fa, "attention",
                        lambda *a, **kw: calls.append(1))
    cfg, _, _, tp = _params("q_lora")
    L.set_attention_impl("kernel")
    try:
        L.apply_mla(tp, cfg, torch.from_numpy(_x(2, 24, seed=2)),
                    torch.from_numpy(_pos(2, 24)))
    finally:
        L.set_attention_impl("plain")
    assert calls == []
