"""The port's token-model stack (``repro_torch.models``, ``configs``,
``data``, ``serve``) against the JAX package's, on the CPU, at the reduced
variants (two periods, d_model 256, vocab 1024, 4 experts top-2; Jamba one
period of 8 layers, with its experts and without), every configuration of
the repo: dense (smollm-135m, qwen2.5-14b, deepseek-7b, qwen1.5-110b),
MoE (grok-1; DeepSeek-V2 with MLA), SSM (rwkv6-7b), hybrid (Jamba),
audio (whisper-medium) and VLM (qwen2-vl-2b, its patch embeddings spliced
over the first positions and M-RoPE positions on a patch grid).

Tolerances: configs and ``synthetic_stream`` exact; norms, RoPE and MLPs
rtol 1e-5 / atol 1e-6 of the output's scale in f32 (sums over d_model
round in another order); the ``forward_train`` loss rtol 1e-5 in f32 under
both backends (port ``"plain"`` against JAX ``"xla"``, port ``"kernel"``
against JAX ``"pallas"`` in interpret mode) and 2e-2 in bf16, its MoE aux
loss rtol 1e-5 (0 without experts); prefill and
decode logits atol 1e-4; greedy tokens equal, except where JAX's top two
logits at that step lie within 1e-4 of each other.  JAX's weights are
carried across with ``from_reference``, with norms, biases and the SSM
mixers' constant leaves drawn away from their initial values so that they
count.
"""

import dataclasses
import os
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import repro.configs as JC  # noqa: E402
from repro.data import pipeline as jpipe  # noqa: E402
from repro.models import layers as JL, model as JM  # noqa: E402
from repro.serve import engine as jserve  # noqa: E402

from chip_smoke import _vlm_grid, jamba_dense, jamba_moe  # noqa: E402
from repro_torch import configs as TC, kernels  # noqa: E402
from repro_torch.data import pipeline as tpipe  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.models import layers as L, model as M  # noqa: E402
from repro_torch.serve import ServeConfig, TokenServingEngine  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# Jamba without experts: the published config cut to one period with every
# FFN a dense SwiGLU (chip_smoke.py's path D), here at its reduced variant
JAMBA_DENSE = "jamba-1.5-large-398b/dense"
PORTED = ["smollm-135m", "qwen2.5-14b", "whisper-medium", "rwkv6-7b",
          JAMBA_DENSE, "deepseek-v2-236b", "grok-1-314b",
          "jamba-1.5-large-398b", "qwen2-vl-2b", "deepseek-7b",
          "qwen1.5-110b"]
_MODELS = {}


def _perturb(tree, rng, path=""):
    """Norm scales 1 + N(0, 0.1) and biases N(0, 0.1) in place of the
    initial ones and zeros; the SSM mixers' other constant leaves drawn
    away from their constants too (token-shift mixes U(0, 1), the rest
    plus N(0, 0.1), w0 plus N(0, 0.5)), so that a swapped ``mu_r`` and
    ``mu_k`` would not pass."""
    if isinstance(tree, dict):
        return {k: _perturb(v, rng, k) for k, v in tree.items()}
    if path.endswith("norm") or path == "ln_scale":
        return (1 + rng.normal(0, 0.1, tree.shape)).astype(tree.dtype)
    if path in ("bq", "bk", "bv", "conv_b"):
        return rng.normal(0, 0.1, tree.shape).astype(tree.dtype)
    if path.startswith("mu_"):
        return rng.uniform(0, 1, tree.shape).astype(tree.dtype)
    if path in ("w0", "dt_bias", "D", "A_log"):
        scale = 0.5 if path == "w0" else 0.1
        return (tree + rng.normal(0, scale, tree.shape)).astype(tree.dtype)
    return tree


def _configs(arch):
    """The port's and JAX's reduced configs of ``arch``."""
    if arch == JAMBA_DENSE:
        return tuple(jamba_dense(pkg.get_config("jamba-1.5-large-398b"))
                     .reduced() for pkg in (TC, JC))
    return TC.get_config(arch).reduced(), JC.get_config(arch).reduced()


def _models(arch):
    """(cfg, jcfg, JAX params, numpy params, port LM), built once per arch."""
    if arch not in _MODELS:
        cfg, jcfg = _configs(arch)
        npp = _perturb(jax.tree.map(
            np.asarray, JM.init_lm(jax.random.PRNGKey(0), jcfg)),
            np.random.default_rng(1))
        jp = jax.tree.map(jnp.asarray, npp)
        _MODELS[arch] = (cfg, jcfg, jp, npp,
                         M.from_reference(npp, cfg, device="cpu"))
    return _MODELS[arch]


def _batch(cfg, seed=0):
    """A ``synthetic_stream`` batch; for the VLM its first nv/2 positions'
    M-RoPE ids on a patch grid (temporal 0, height i // 4, width i % 4),
    the rest the text's own position in all three planes, as decode
    gives them."""
    dc = tpipe.DataConfig(seq_len=64 if cfg.enc_dec else 32, global_batch=2,
                          seed=seed)
    batch = next(tpipe.synthetic_stream(cfg, dc))
    if cfg.family == "vlm":
        _vlm_grid(batch, width=4, n=batch["vision_embed"].shape[1] // 2)
    return batch


def _jnp(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _close(got, want, **tol):
    want = np.asarray(want)
    tol = tol or dict(rtol=1e-5,
                      atol=1e-6 * max(1.0, float(np.abs(want).max())))
    np.testing.assert_allclose(got.float().numpy(), want, **tol)


@pytest.fixture
def impls():
    def select(jax_impl, port_impl):
        JL.set_attention_impl(jax_impl)
        L.set_attention_impl(port_impl)
    yield select
    JL.set_attention_impl("xla")
    L.set_attention_impl("plain")


# -- configs and data -------------------------------------------------------

def test_config_module_is_a_verbatim_copy():
    assert ((ROOT / "src" / "repro_torch" / "models" / "config.py")
            .read_bytes()
            == (ROOT / "src" / "repro" / "models" / "config.py").read_bytes())


@pytest.mark.parametrize("arch", sorted(JC.ARCHS))
def test_configs_equal(arch):
    j, t = JC.get_config(arch), TC.get_config(arch)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert dataclasses.asdict(t.reduced()) == dataclasses.asdict(j.reduced())
    assert t.param_count() == j.param_count()
    assert t.active_param_count() == j.active_param_count()
    assert t.reduced().param_count() == j.reduced().param_count()
    assert list(TC.ARCHS) == list(JC.ARCHS)


@pytest.mark.parametrize("arch", ["smollm-135m", "whisper-medium"])
def test_synthetic_stream_bit_identical(arch):
    cfg = TC.get_config(arch)
    for dc_kw, shard in ((dict(seq_len=256, global_batch=4, seed=3), 0),
                         (dict(seq_len=64, global_batch=8, seed=0), 1)):
        tstream = tpipe.synthetic_stream(cfg, tpipe.DataConfig(**dc_kw),
                                         shard=shard, n_shards=2)
        jstream = jpipe.synthetic_stream(JC.get_config(arch),
                                         jpipe.DataConfig(**dc_kw),
                                         shard=shard, n_shards=2)
        for _ in range(3):
            a, b = next(tstream), next(jstream)
            assert sorted(a) == sorted(b)
            for k in a:
                assert a[k].dtype == b[k].dtype
                np.testing.assert_array_equal(a[k], b[k])
    assert tpipe.dec_len(cfg, 4096) == jpipe.dec_len(JC.get_config(arch), 4096)


# -- layers -----------------------------------------------------------------

def test_rmsnorm_matches():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 5, 64)).astype(np.float32)
    s = (1 + rng.normal(0, 0.1, 64)).astype(np.float32)
    _close(L.rmsnorm(torch.from_numpy(x), torch.from_numpy(s), 1e-6),
           JL.rmsnorm(jnp.asarray(x), jnp.asarray(s), 1e-6))


@pytest.mark.parametrize("sections", [None, (8, 12, 12)])
def test_rope_matches(sections):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 11, 3, 64)).astype(np.float32)
    if sections is None:
        pos = rng.integers(0, 4096, size=(2, 11)).astype(np.int32)
    else:
        pos = rng.integers(0, 64, size=(3, 2, 11)).astype(np.int32)
    want = JL.rope_apply(jnp.asarray(x), jnp.asarray(pos), 1e4, sections)
    got = L.rope_apply(torch.from_numpy(x), torch.from_numpy(pos), 1e4,
                       sections)
    _close(got, want)
    np.testing.assert_allclose(L.rope_freqs(64, 1e6).numpy(),
                               np.asarray(JL.rope_freqs(64, 1e6)), rtol=1e-6)


@pytest.mark.parametrize("kind", ["mlp", "gelu_mlp"])
def test_mlp_matches(kind):
    p = jax.tree.map(np.asarray,
                     JL.init_mlp(jax.random.PRNGKey(3), 64, 160, kind))
    x = np.random.default_rng(2).normal(size=(2, 7, 64)).astype(np.float32)
    got = L.apply_mlp({k: torch.from_numpy(np.array(a)) for k, a in p.items()},
                      torch.from_numpy(x), kind)
    _close(got, JL.apply_mlp(p, jnp.asarray(x), kind))


# -- models -----------------------------------------------------------------

@pytest.mark.parametrize("backends", [("xla", "plain"), ("pallas", "kernel")])
@pytest.mark.parametrize("arch", PORTED)
def test_forward_train_loss_matches(arch, backends, impls):
    impls(*backends)
    cfg, jcfg, jp, _, lm = _models(arch)
    batch = _batch(cfg)
    jl, jm = JM.forward_train(jp, jcfg, _jnp(batch), dtype=jnp.float32)
    tl, tm = M.forward_train(lm, cfg, batch, dtype=torch.float32)
    print(f"{arch} {backends}: loss jax {float(jl)!r} port {float(tl)!r}, "
          f"aux jax {float(jm['aux_loss'])!r} port {float(tm['aux_loss'])!r}")
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    assert float(tm["acc"]) == pytest.approx(float(jm["acc"]), abs=1e-6)
    assert tl.dtype == torch.float32
    np.testing.assert_allclose(float(tm["aux_loss"]), float(jm["aux_loss"]),
                               rtol=1e-5)
    assert (float(tm["aux_loss"]) > 0) == (cfg.moe is not None)


def test_forward_train_bf16_matches():
    cfg, jcfg, jp, _, lm = _models("smollm-135m")
    batch = _batch(cfg, seed=1)
    jl, _ = JM.forward_train(jp, jcfg, _jnp(batch), dtype=jnp.bfloat16)
    tl, _ = M.forward_train(lm, cfg, batch, dtype=torch.bfloat16)
    np.testing.assert_allclose(float(tl), float(jl), rtol=2e-2)


@pytest.mark.parametrize("arch", ["rwkv6-7b", JAMBA_DENSE])
def test_ssm_forward_train_bf16_matches(arch):
    """bf16 at smollm's tier.  JAX's Mamba step rounds Δ·x·B in bf16
    before its f32 scan, the port (as the TPU kernel) converts first."""
    cfg, jcfg, jp, _, lm = _models(arch)
    batch = _batch(cfg, seed=1)
    jl, _ = JM.forward_train(jp, jcfg, _jnp(batch), dtype=jnp.bfloat16)
    tl, _ = M.forward_train(lm, cfg, batch, dtype=torch.bfloat16)
    print(f"{arch} bf16: loss jax {float(jl)!r} port {float(tl)!r}, "
          f"relative {abs(float(tl) - float(jl)) / abs(float(jl))!r}")
    np.testing.assert_allclose(float(tl), float(jl), rtol=2e-2)


def _prompt(cfg, batch, S):
    """The batch's first S tokens with what goes with them: whisper's
    frames, or the VLM's first S // 2 patch embeddings and M-RoPE ids."""
    out = {"tokens": batch["tokens"][:, :S]}
    if cfg.enc_dec:
        out["audio_embed"] = batch["audio_embed"]
    if cfg.family == "vlm":
        out["vision_embed"] = batch["vision_embed"][:, :S // 2]
        out["rope_pos"] = batch["rope_pos"][:, :, :S]
    return out


@pytest.mark.parametrize("arch", PORTED)
def test_prefill_and_decode_logits_match(arch):
    cfg, jcfg, jp, _, lm = _models(arch)
    batch, B, S = _batch(cfg), 2, 16
    Se = batch["audio_embed"].shape[1] if cfg.enc_dec else 0
    jc = JM.make_caches(jcfg, B, S + 1, jnp.float32, enc_len=Se)
    tc = M.make_caches(cfg, B, S + 1, torch.float32, enc_len=Se)
    jlog, jc = JM.prefill(jp, jcfg, _jnp(_prompt(cfg, batch, S)), jc,
                          dtype=jnp.float32)
    tlog, tc2 = M.prefill(lm, cfg, _prompt(cfg, batch, S), tc,
                          dtype=torch.float32)
    assert tc2 is tc and tlog.shape == (B, 1, cfg.vocab)
    _close(tlog, jlog, rtol=0, atol=1e-4)
    nxt = batch["tokens"][:, S:S + 1]
    jlog, _ = JM.decode_step(jp, jcfg, jc, jnp.asarray(nxt), jnp.int32(S),
                             dtype=jnp.float32)
    tlog, _ = M.decode_step(lm, cfg, tc, torch.from_numpy(nxt), S,
                            dtype=torch.float32)
    _close(tlog, jlog, rtol=0, atol=1e-4)


@pytest.mark.parametrize("arch", PORTED)
def test_decode_matches_longer_prefill(arch):
    """Decoding token S after a prefill of S tokens gives the logits of a
    prefill of S + 1 tokens: the cache path is exact, not approximate."""
    cfg, _, _, _, lm = _models(arch)
    batch, B, S = _batch(cfg, seed=2), 2, 16
    Se = batch["audio_embed"].shape[1] if cfg.enc_dec else 0
    caches = M.make_caches(cfg, B, S + 1, torch.float32, enc_len=Se)
    M.prefill(lm, cfg, _prompt(cfg, batch, S), caches, dtype=torch.float32)
    dec, _ = M.decode_step(lm, cfg, caches,
                           torch.from_numpy(batch["tokens"][:, S:S + 1]), S,
                           dtype=torch.float32)
    full, _ = M.prefill(lm, cfg, _prompt(cfg, batch, S + 1),
                        M.make_caches(cfg, B, S + 1, torch.float32,
                                      enc_len=Se), dtype=torch.float32)
    torch.testing.assert_close(dec, full, rtol=0, atol=1e-4)


@pytest.mark.parametrize("arch", PORTED)
def test_generate_matches_jax_tokens(arch):
    cfg, jcfg, jp, _, lm = _models(arch)
    batch, B, S, n = _batch(cfg, seed=3), 2, 16, 8
    Se = batch["audio_embed"].shape[1] if cfg.enc_dec else 0
    jeng = jserve.TokenServingEngine(
        jcfg, jp, jserve.ServeConfig(batch=B, cache_len=S + n,
                                     dtype=jnp.float32, enc_len=Se))
    teng = TokenServingEngine(
        cfg, lm, ServeConfig(batch=B, cache_len=S + n, dtype=torch.float32,
                             enc_len=Se), device="cpu")
    first = jeng.prefill_prompt(_jnp(_prompt(cfg, batch, S)))[:, -1].argmax(-1)
    teng.prefill_prompt(_prompt(cfg, batch, S))
    got = teng.generate(np.asarray(first), n)
    # JAX's own greedy loop (TokenServingEngine.generate), keeping logits
    tok, want, gaps = first.reshape(B, 1).astype(jnp.int32), [], []
    for _ in range(n):
        logits, jeng.caches = jeng.step(jeng.params, jeng.caches, tok,
                                        jnp.int32(jeng.pos))
        top2 = np.sort(np.asarray(logits[:, -1]), axis=-1)[:, -2:]
        gaps.append(top2[:, 1] - top2[:, 0])
        tok = logits[:, -1, :].argmax(-1).astype(jnp.int32).reshape(-1, 1)
        want.append(np.asarray(tok))
        jeng.pos += 1
    want = np.concatenate(want, axis=1)
    assert got.shape == (B, n) and got.dtype == np.int32
    for r in range(B):
        diff = np.flatnonzero(got[r] != want[r])
        if diff.size:   # later tokens follow another history
            t = diff[0]
            print(f"{arch} row {r}: token {t} differs (port {got[r, t]}, jax "
                  f"{want[r, t]}), JAX's top-2 gap {gaps[t][r]!r}")
            assert gaps[t][r] <= 1e-4


def test_from_reference_carries_every_leaf():
    """Every JAX leaf (every period's slice of a stacked leaf) lands in
    exactly one port parameter of the same shape and values; no port
    parameter is left over; ``init_lm`` builds the same names and shapes."""
    for arch in PORTED:
        cfg, _, _, npp, lm = _models(arch)
        params = dict(lm.named_parameters())
        seen = set()
        for path, leaf in jax.tree_util.tree_flatten_with_path(npp)[0]:
            keys = [p.key for p in path]
            if keys[0] in ("blocks", "enc_blocks"):
                P = len(cfg.period) if keys[0] == "blocks" else 1
                j = int(keys[1][3:])
                names = [(".".join([keys[0], str(i * P + j)] + keys[2:]),
                          leaf[i]) for i in range(leaf.shape[0])]
            else:
                names = [(".".join(keys), leaf)]
            for name, want in names:
                assert name in params and name not in seen, name
                seen.add(name)
                assert tuple(params[name].shape) == want.shape, name
                np.testing.assert_array_equal(params[name].numpy(), want)
        assert seen == set(params)
        fresh = M.init_lm(cfg, 5, device="cpu")
        assert ({n: p.shape for n, p in fresh.named_parameters()}
                == {n: p.shape for n, p in params.items()})


def test_kernel_backend_routes_the_jax_calls(monkeypatch, impls):
    """Under ``"kernel"`` the wrapper is called once per layer for the
    scoring pass of smollm, grok-1 and qwen2-vl (once for Jamba's one
    attention layer, with its experts or without) and never for their
    serving; for whisper once per encoder layer and per cross-attention at
    prefill, and per cross-attention at every decode step; never for
    DeepSeek-V2, whose MLA passes an explicit scale.  Under ``"plain"``
    never."""
    calls = []
    real = fa.attention
    monkeypatch.setattr(fa, "attention",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    for impl in ("plain", "kernel"):
        impls("xla", impl)
        for arch, (fwd, pre, dec) in (("smollm-135m", (2, 0, 0)),
                                      ("whisper-medium", (6, 4, 2)),
                                      ("rwkv6-7b", (0, 0, 0)),
                                      (JAMBA_DENSE, (1, 0, 0)),
                                      ("grok-1-314b", (2, 0, 0)),
                                      ("deepseek-v2-236b", (0, 0, 0)),
                                      ("jamba-1.5-large-398b", (1, 0, 0)),
                                      ("qwen2-vl-2b", (2, 0, 0))):
            cfg, _, _, _, lm = _models(arch)
            batch = _batch(cfg)
            Se = batch["audio_embed"].shape[1] if cfg.enc_dec else 0
            counts = []
            del calls[:]
            M.forward_train(lm, cfg, batch, dtype=torch.float32)
            counts.append(len(calls))
            eng = TokenServingEngine(
                cfg, lm, ServeConfig(batch=2, cache_len=24,
                                     dtype=torch.float32, enc_len=Se),
                device="cpu")
            del calls[:]
            eng.prefill_prompt(_prompt(cfg, batch, 8))
            counts.append(len(calls))
            del calls[:]
            eng.generate(np.zeros(2, np.int32), 3)
            counts.append(len(calls) // 3)
            want = [fwd, pre, dec] if impl == "kernel" else [0, 0, 0]
            assert counts == want, (arch, impl, counts)


def test_ssm_kernels_run_every_recurrence(monkeypatch):
    """``kernels.rwkv6`` is called once per RWKV layer and ``kernels.
    mamba_scan`` once per Mamba layer, at scoring, at prefill and at every
    decoded token (the scan has no other path), on contiguous tensors."""
    calls = {"rwkv6": 0, "mamba_scan": 0}
    for name in calls:
        real = getattr(kernels, name)

        def counted(*a, _real=real, _name=name, **kw):
            # the kernel takes contiguous tensors only
            assert all(t.is_contiguous() for t in a), _name
            calls[_name] += 1
            return _real(*a, **kw)
        monkeypatch.setattr(kernels, name, counted)
    for arch, name, layers_per_pass in (("rwkv6-7b", "rwkv6", 2),
                                        (JAMBA_DENSE, "mamba_scan", 7),
                                        ("jamba-1.5-large-398b",
                                         "mamba_scan", 7)):
        cfg, _, _, _, lm = _models(arch)
        batch = _batch(cfg)
        eng = TokenServingEngine(
            cfg, lm, ServeConfig(batch=2, cache_len=24, dtype=torch.float32),
            device="cpu")
        counts = []
        for run in (lambda: M.forward_train(lm, cfg, batch,
                                            dtype=torch.float32),
                    lambda: eng.prefill_prompt(_prompt(cfg, batch, 8)),
                    lambda: eng.generate(np.zeros(2, np.int32), 3)):
            calls.update(rwkv6=0, mamba_scan=0)
            run()
            counts.append(dict(calls))
        other = "mamba_scan" if name == "rwkv6" else "rwkv6"
        assert [c[name] for c in counts] == [layers_per_pass,
                                             layers_per_pass,
                                             3 * layers_per_pass], arch
        assert all(c[other] == 0 for c in counts), arch


def test_jamba_moe_cut_matches():
    """``chip_smoke.jamba_moe`` (phase 19c's Jamba with experts): the
    published config's in-period layers 4-5, every width kept; at its
    reduced variant the port's loss and aux loss equal JAX's."""
    cfg, jcfg = (jamba_moe(pkg.get_config("jamba-1.5-large-398b"))
                 for pkg in (TC, JC))
    full = TC.get_config("jamba-1.5-large-398b")
    assert cfg.period == (("attn", "mlp"), ("mamba", "moe"))
    assert cfg.n_layers == 2 and cfg.moe == full.moe
    assert (cfg.d_model, cfg.d_ff, cfg.vocab) == (full.d_model, full.d_ff,
                                                  full.vocab)
    cfg, jcfg = cfg.reduced(), jcfg.reduced()
    npp = _perturb(jax.tree.map(
        np.asarray, JM.init_lm(jax.random.PRNGKey(2), jcfg)),
        np.random.default_rng(3))
    lm = M.from_reference(npp, cfg, device="cpu")
    batch = _batch(cfg)
    jl, jm = JM.forward_train(jax.tree.map(jnp.asarray, npp), jcfg,
                              _jnp(batch), dtype=jnp.float32)
    tl, tm = M.forward_train(lm, cfg, batch, dtype=torch.float32)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    np.testing.assert_allclose(float(tm["aux_loss"]), float(jm["aux_loss"]),
                               rtol=1e-5)


@pytest.fixture
def one_thread():
    """One torch thread for the test (see tests/test_torch_train.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.usefixtures("one_thread")
@pytest.mark.parametrize("arch", ["smollm-135m", "whisper-medium",
                                  "rwkv6-7b", JAMBA_DENSE])
def test_remat_matches(arch):
    """``RunFlags(remat=True)`` (each decoder and encoder layer recomputed
    in the backward pass) gives the loss and every gradient of
    ``remat=False`` bit for bit: it changes what is kept, not what is
    computed."""
    cfg, _, _, npp, _ = _models(arch)
    lm = M.from_reference(npp, cfg, device="cpu").requires_grad_()
    batch = _batch(cfg)
    out = []
    for remat in (False, True):
        loss, _ = M.forward_train(lm, cfg, batch, M.RunFlags(remat=remat),
                                  dtype=torch.float32)
        out.append((loss.detach(), torch.autograd.grad(
            loss, list(lm.parameters()))))
    (la, ga), (lb, gb) = out
    assert torch.equal(la, lb)
    assert all(torch.equal(a, b) for a, b in zip(ga, gb))


@pytest.mark.usefixtures("one_thread")
@pytest.mark.parametrize("arch", ["smollm-135m", "rwkv6-7b", JAMBA_DENSE])
def test_serving_trainable_weights(arch):
    """A ``TokenServingEngine`` over weights that require gradients (a
    model in training) decodes the tokens of the same weights without
    them, and leaves no cache that requires a gradient or holds an
    autograd history (``torch.inference_mode``)."""
    cfg, _, _, npp, lm = _models(arch)
    trainable = M.from_reference(npp, cfg, device="cpu").requires_grad_()
    batch = _batch(cfg, seed=3)
    toks = []
    for params in (lm, trainable):
        eng = TokenServingEngine(cfg, params, ServeConfig(
            batch=2, cache_len=24, dtype=torch.float32), device="cpu")
        logits = eng.prefill_prompt(_prompt(cfg, batch, 16))
        toks.append(eng.generate(np.asarray(logits[:, -1].argmax(-1)), 8))
        for cache in eng.caches:
            for name, t in cache.items():
                assert not t.requires_grad and t.grad_fn is None, name
        assert not logits.requires_grad
    np.testing.assert_array_equal(toks[0], toks[1])
