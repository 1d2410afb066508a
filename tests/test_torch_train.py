"""The port's training (``repro_torch.optim``, ``repro_torch.train``,
``launch.train``, gradients through ``models`` and the scan kernels'
autograd Functions) against the JAX package's, on the CPU, at reduced
configs (two periods, d_model 256, vocab 1024; Jamba one period of 8
layers with its experts).

Tolerances: ``forward_train``'s loss rtol 1e-5 and every leaf's gradient
max |diff| <= 1e-5 · max(1, max |g|) against ``jax.grad`` in f32 (JAX's
gradients carried into the port's layout with ``from_reference``); the
schedules equal; AdamW against JAX's eager update with f32 moments to
rtol 1e-6 (the weights also atol 1e-8: updates of ~3e-3 round a few times
in another order), with bf16 moments each moment leaf within one bf16
rounding of its scale (2**-7 · max |mu|: a rounding that goes the other
way carries into later steps) and the weights to atol 1e-6; one train
step (microbatches 1 and 2) against JAX's jitted step at JAX's own
microbatch test's lr and tier (3e-4; rtol 1e-4, atol 1e-5 on the weights)
except where the gradient lies within 100 eps of 0: AdamW's first step is
lr · g / (|g| + eps), which turns there on the gradient's last bits, and
such weights are held to the update's range (lr); the first moment
(0.1 · the clipped gradient) to 1e-5 of its scale, metrics rtol 1e-5; the WKV and selective-scan Functions' gradients against
autograd through the unchunked plain versions (each sequence input's
exact; a shared input's to 1e-6 of its scale, its chunks summed in
another order); checkpoints equal bit for bit across the packages.
Weights come from the JAX package's ``init_lm`` with norms and biases
drawn away from their constants; batches from ``synthetic_stream``.
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
from repro.models import model as JM  # noqa: E402
from repro.optim import adamw as JA, schedule as JS  # noqa: E402
from repro.train import checkpoint as JCk, trainer as JT  # noqa: E402

from chip_smoke import _vlm_grid  # noqa: E402
from repro_torch import configs as TC, kernels  # noqa: E402
from repro_torch.data import pipeline as tpipe  # noqa: E402
from repro_torch.kernels import _grad  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models import layers as L, model as M  # noqa: E402
from repro_torch.optim import adamw as TA, schedule as TS  # noqa: E402
from repro_torch.train import checkpoint as TCk, trainer as TT  # noqa: E402

FAMILIES = ["smollm-135m", "rwkv6-7b", "jamba-1.5-large-398b", "grok-1-314b",
            "deepseek-v2-236b", "whisper-medium", "qwen2-vl-2b"]
_CACHE = {}


@pytest.fixture(autouse=True)
def one_thread():
    """One torch thread a test: the suite runs several workers on the
    host's cores, and a worker's thread pool waiting on busy cores made
    these many small operations up to 60 times slower.  The values are
    the same on any thread count."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _perturb(tree, rng, name=""):
    """Norm scales 1 + N(0, 0.1), biases and the SSM mixers' constant
    leaves moved by N(0, 0.1), so that their gradients are tested away
    from the initial values."""
    if isinstance(tree, dict):
        return {k: _perturb(v, rng, k) for k, v in tree.items()}
    if name.endswith("norm") or name == "ln_scale":
        return (1 + rng.normal(0, 0.1, tree.shape)).astype(tree.dtype)
    if name in ("bq", "bk", "bv", "conv_b", "w0", "dt_bias", "D", "A_log"):
        return (tree + rng.normal(0, 0.1, tree.shape)).astype(tree.dtype)
    if name.startswith("mu_"):
        return rng.uniform(0, 1, tree.shape).astype(tree.dtype)
    return tree


def _model(arch):
    """(cfg, jcfg, numpy params in JAX's layout), built once per arch."""
    if arch not in _CACHE:
        cfg, jcfg = TC.get_config(arch).reduced(), JC.get_config(arch).reduced()
        npp = _perturb(jax.tree.map(
            np.asarray, JM.init_lm(jax.random.PRNGKey(0), jcfg)),
            np.random.default_rng(1))
        _CACHE[arch] = (cfg, jcfg, npp)
    return _CACHE[arch]


def _batch(cfg, B=2, S=128, seed=0):
    dc = tpipe.DataConfig(seq_len=S, global_batch=B, seed=seed)
    return _vlm_grid(next(tpipe.synthetic_stream(cfg, dc)), width=8)


def _jnp(tree):
    return jax.tree.map(jnp.asarray, tree)


def _leaf_close(got, want, scale_tol):
    """max |got - want| <= scale_tol · max(1, max |want|)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = float(np.abs(got - want).max()) if want.size else 0.0
    return err <= scale_tol * max(1.0, float(np.abs(want).max())), err


# -- gradients of forward_train ------------------------------------------

@pytest.mark.parametrize("arch", FAMILIES)
def test_forward_train_gradients_match(arch):
    cfg, jcfg, npp = _model(arch)
    batch = _batch(cfg)

    def loss_fn(p, b):
        return JM.forward_train(p, jcfg, b, dtype=jnp.float32)[0]

    jl, jg = jax.jit(jax.value_and_grad(loss_fn))(_jnp(npp), _jnp(batch))
    want = dict(M.from_reference(jax.tree.map(np.asarray, jg), cfg,
                                 device="cpu").named_parameters())
    lm = M.from_reference(npp, cfg, device="cpu").requires_grad_()
    names, params = zip(*lm.named_parameters())
    loss, _ = M.forward_train(lm, cfg, batch, dtype=torch.float32)
    grads = torch.autograd.grad(loss, params)
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)
    assert set(names) == set(want)
    worst = (0.0, None)
    for name, g in zip(names, grads):
        ok, err = _leaf_close(g.numpy(), want[name].detach().numpy(), 1e-5)
        assert ok, (arch, name, err)
        worst = max(worst, (err, name))
    print(f"{arch}: worst leaf {worst[1]} max |diff| {worst[0]:.3g}")


def test_attention_kernel_refuses_gradients(monkeypatch):
    """Under ``"kernel"`` a differentiable pass raises (the flash kernel has
    no backward); without gradients it runs as before."""
    cfg, _, npp = _model("smollm-135m")
    lm = M.from_reference(npp, cfg, device="cpu")
    batch = _batch(cfg, S=32)
    monkeypatch.setattr(L, "_ATTN_IMPL", "kernel")
    M.forward_train(lm, cfg, batch, dtype=torch.float32)
    lm.requires_grad_()
    with pytest.raises(RuntimeError, match="no backward"):
        M.forward_train(lm, cfg, batch, dtype=torch.float32)
    with torch.no_grad():
        M.forward_train(lm, cfg, batch, dtype=torch.float32)


@pytest.mark.parametrize("arch", ["rwkv6-7b", "jamba-1.5-large-398b"])
def test_stateful_scan_refuses_gradients(arch):
    """Prefill from a carried state has no gradient path: it raises under
    autograd, where a silent raw launch would drop the gradient."""
    cfg, _, npp = _model(arch)
    lm = M.from_reference(npp, cfg, device="cpu").requires_grad_()
    caches = M.make_caches(cfg, 2, 16, dtype=torch.float32)
    with pytest.raises(RuntimeError, match="carried state"):
        M.prefill(lm, cfg, {"tokens": _batch(cfg, S=16)["tokens"]}, caches,
                  dtype=torch.float32)


def test_refuse_grad_only_when_a_gradient_would_be_lost():
    """The raw wrappers' guard (on the card, before any launch): it raises
    exactly when autograd would record an operation on an input."""
    a, b = torch.ones(2), torch.ones(2, requires_grad=True)
    _grad.refuse_grad("k", "x", a, a)
    with pytest.raises(RuntimeError, match="call x"):
        _grad.refuse_grad("k", "x", a, b)
    with torch.no_grad():
        _grad.refuse_grad("k", "x", a, b)
    with torch.inference_mode():
        _grad.refuse_grad("k", "x", b)


# -- the scan Functions ------------------------------------------------------

def _scan_inputs(kind, S, dtype, seed=0):
    rng = np.random.default_rng(seed)

    def t(shape, lo=None, hi=None, cast=True):
        a = (rng.uniform(lo, hi, shape) if lo is not None
             else rng.normal(0, 1, shape))
        a = torch.tensor(a, dtype=torch.float32)
        return (a.to(dtype) if cast else a).requires_grad_()

    B = 2
    if kind == "rwkv6":
        H, hd = 2, 32
        return (t((B, S, H, hd)), t((B, S, H, hd)), t((B, S, H, hd)),
                t((B, S, H, hd), 0.3, 0.999, cast=False),
                t((H, hd), cast=False))
    di, ds = 48, 16
    return (t((B, S, di)), t((B, S, di), 0.001, 0.2),
            t((di, ds), -2.0, -0.05, cast=False), t((B, S, ds)),
            t((B, S, ds)))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S", [64, 200])
@pytest.mark.parametrize("kind", ["rwkv6", "mamba_scan"])
def test_scan_function_gradients(kind, S, dtype):
    """The Functions' chunked backward (a short last chunk at S=200) against
    autograd through the unchunked plain version, with gradients on y and
    on the final state; the forward is the wrapper's."""
    fn = getattr(kernels, f"{kind}_autograd")
    plain = getattr(kernels, f"{kind}_plain")
    inputs = _scan_inputs(kind, S, dtype)
    y, st = fn(*inputs)
    y0, st0 = plain(*inputs)
    assert torch.equal(y, y0) and torch.equal(st, st0)
    rng = np.random.default_rng(7)
    gy = torch.tensor(rng.normal(0, 1, y.shape), dtype=y.dtype)
    gs = torch.tensor(rng.normal(0, 1, st.shape), dtype=st.dtype)
    got = torch.autograd.grad((y, st), inputs, (gy, gs))
    want = torch.autograd.grad((y0, st0), inputs, (gy, gs))
    shared = 4 if kind == "rwkv6" else 2          # u, A: summed per chunk
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == inputs[i].dtype
        if i == shared:
            ok, err = _leaf_close(g.numpy(), w.numpy(), 1e-6)
            assert ok, (kind, i, err)
        else:
            assert torch.equal(g, w), (kind, i)


# -- optimiser and schedules -------------------------------------------------

def test_schedules_equal():
    for total, warmup in ((20, 2), (200, 20), (1000, 50), (7, 3), (3, 5),
                          (1, 0)):
        for step in range(total + 3):
            want = np.float32(JS.cosine_schedule(jnp.int32(step), warmup,
                                                 total))
            assert TS.cosine_schedule(step, warmup, total) == want, (
                total, warmup, step)
            want = np.float32(JS.linear_warmup(jnp.int32(step), warmup))
            assert TS.linear_warmup(step, warmup) == want


def _sorted(tree):
    """numpy leaves in ``jax.tree.leaves`` order (keys sorted)."""
    if isinstance(tree, dict):
        return {k: _sorted(tree[k]) for k in sorted(tree)}
    return tree


@pytest.mark.parametrize("moments", ["f32", "bf16"])
def test_adamw_matches(moments):
    """Three updates with random gradients (the first clipped, the others
    not) and the cosine schedule's scales, over the reduced smollm's
    weights in JAX's layout."""
    _, _, npp = _model("smollm-135m")
    npp = _sorted(npp)
    rng = np.random.default_rng(3)
    cfg = JA.AdamWConfig(lr=3e-3, moment_dtype=moments)
    tcfg = TA.AdamWConfig(lr=3e-3, moment_dtype=moments)
    jp, js = _jnp(npp), JA.adamw_init(_jnp(npp), moments)
    tp = jax.tree.map(lambda a: torch.tensor(a), npp)
    ts = TA.adamw_init(tp, moments)
    for step, scale in enumerate((2.0, 0.02, 0.05)):
        g = jax.tree.map(lambda a: (rng.normal(0, scale, a.shape)
                                    .astype(np.float32)), npp)
        lr_scale = JS.cosine_schedule(js["step"], 2, 10)
        jp, js, jm = JA.adamw_update(cfg, jp, _jnp(g), js, lr_scale)
        tp, ts, tm = TA.adamw_update(
            tcfg, tp, jax.tree.map(torch.tensor, g), ts,
            TS.cosine_schedule(ts["step"], 2, 10))
        assert int(ts["step"]) == int(js["step"]) == step + 1
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-6)
        for part, got, want in (("mu", ts["mu"], js["mu"]),
                                ("nu", ts["nu"], js["nu"]),
                                ("params", tp, jp)):
            got = jax.tree.leaves(jax.tree.map(
                lambda t: t.float().numpy(), got))
            want = jax.tree.leaves(jax.tree.map(
                lambda a: np.asarray(a, np.float32), want))
            for a, b in zip(got, want):
                scale = float(np.abs(b).max())
                if part == "params":
                    tol = dict(rtol=1e-6, atol=1e-8 if moments == "f32"
                               else 2 ** -6 * cfg.lr)
                elif moments == "f32":
                    tol = dict(rtol=1e-6, atol=1e-6 * scale)
                else:   # a rounding to bf16 may go the other way
                    tol = dict(rtol=0, atol=2 ** -7 * scale)
                np.testing.assert_allclose(a, b, err_msg=part, **tol)


# -- the train step ----------------------------------------------------------

def _train_configs(mb):
    """JAX's and the port's f32 ``TrainConfig`` with ``microbatches=mb``."""
    kw = dict(microbatches=mb, warmup=2, steps=10)
    return (JT.TrainConfig(dtype=jnp.float32, **kw),
            TT.TrainConfig(dtype=torch.float32, **kw))


def _jax_step(mb):
    """JAX's jitted train step on the reduced smollm, compiled once."""
    key = ("step", mb)
    if key not in _CACHE:
        _, jcfg, _ = _model("smollm-135m")
        _CACHE[key] = jax.jit(JT.make_train_step(jcfg, _train_configs(mb)[0]))
    return _CACHE[key]


def _hold_step(cfg, ttc, lm, ts, tm, jp, js, jm):
    """The port's step against JAX's: the metrics to rtol 1e-5, each first
    moment (0.1 · the clipped gradient after one step) to 1e-5 of its
    scale, the weights at JAX's microbatch tier.  Where the first moment
    lies within 100 eps of 0 the update lr · mu / (|mu| + eps) turns on
    its last bits: those weights are held to the update's range, 2 lr,
    their gradient through the first moment.  Returns their number."""
    assert set(tm) == set(jm)
    for k in ("loss", "acc", "grad_norm", "lr_scale"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5,
                                   err_msg=k)
    assert int(ts["step"]) == int(js["step"])
    lr = ttc.optim.lr * float(jm["lr_scale"])
    near = 0
    for a, b, m, jmu in zip(*(jax.tree.leaves(jax.tree.map(np.asarray, t))
                              for t in (M.to_reference(lm, cfg), jp,
                                        M.to_reference(ts["mu"], cfg),
                                        js["mu"]))):
        np.testing.assert_allclose(m, jmu, rtol=0,
                                   atol=1e-5 * float(np.abs(jmu).max()))
        tiny = np.abs(jmu) < 0.1 * 100 * ttc.optim.eps
        np.testing.assert_allclose(a[~tiny], b[~tiny], rtol=1e-4, atol=1e-5)
        assert np.abs(a - b)[tiny].max(initial=0) <= 2 * lr
        near += int(tiny.sum())
    return near


@pytest.mark.parametrize("mb", [1, 2])
def test_train_step_matches_jax(mb):
    """One step of ``make_train_step`` (f32) against JAX's jitted step, the
    batch's rows split into two microbatches or not."""
    cfg, _, npp = _model("smollm-135m")
    batch = _batch(cfg, B=4, S=32, seed=2)
    _, ttc = _train_configs(mb)
    jp = _jnp(npp)
    jp, js, jm = _jax_step(mb)(jp, JA.adamw_init(jp), _jnp(batch))
    lm = M.from_reference(npp, cfg, device="cpu")
    lm, ts, tm = TT.make_train_step(cfg, ttc)(lm, TA.adamw_init(lm), batch)
    near = _hold_step(cfg, ttc, lm, ts, tm, jp, js, jm)
    print(f"microbatches={mb}: {near} weights with |g| < 100 eps")


def test_resume_from_jax_checkpoint_matches_jax(tmp_path):
    """JAX takes a step and saves; the port loads that checkpoint (whose
    keys the npz file lists sorted, not in ``LM.tree()``'s order) and takes
    the second step, held against JAX's second step."""
    cfg, _, npp = _model("smollm-135m")
    b1, b2 = (_batch(cfg, B=4, S=32, seed=s) for s in (2, 3))
    _, ttc = _train_configs(1)
    step = _jax_step(1)
    jp = _jnp(npp)
    jp, js, _ = step(jp, JA.adamw_init(jp), _jnp(b1))
    JCk.save_checkpoint(str(tmp_path), jp, js, step=1)
    jp, js, jm = step(jp, js, _jnp(b2))
    lm, opt, at = TCk.load_checkpoint(str(tmp_path), cfg, device="cpu")
    assert at == 1
    lm, ts, tm = TT.make_train_step(cfg, ttc)(lm, opt, b2)
    _hold_step(cfg, ttc, lm, ts, tm, jp, js, jm)
    for a, b in zip(jax.tree.leaves(M.to_reference(ts["nu"], cfg)),
                    jax.tree.leaves(js["nu"])):
        np.testing.assert_allclose(a, np.asarray(b), rtol=0,
                                   atol=1e-5 * float(np.abs(b).max()))


def test_adamw_pairs_leaves_by_key():
    """Moments whose keys are listed in another order update the same
    weights by the same amounts; moments shaped unlike their weights raise
    before anything is written."""
    rng = np.random.default_rng(5)
    shapes = {"norm": (4,), "w": (3, 4), "sub": {"mu_k": (4,)}}

    def draw(f=lambda a: a):
        return M.map_tree(lambda s: torch.tensor(f(rng.normal(0, 1, s)),
                                                 dtype=torch.float32), shapes)

    params, grads, mu, nu = draw(), draw(), draw(), draw(np.abs)
    cfg = TA.AdamWConfig(lr=1e-2)

    def run(order):
        st = {"mu": {k: M.map_tree(torch.clone, mu[k]) for k in order},
              "nu": {k: M.map_tree(torch.clone, nu[k]) for k in order},
              "step": torch.tensor(1, dtype=torch.int32)}
        p, st, _ = TA.adamw_update(cfg, M.map_tree(torch.clone, params),
                                   grads, st)
        return [p, {k: st["mu"][k] for k in shapes}]

    a, b = run(("norm", "w", "sub")), run(("sub", "w", "norm"))
    assert all(torch.equal(x, y) for x, y in zip(TA.leaves(a),
                                                 TA.leaves(b)))
    p = M.map_tree(torch.clone, params)
    swapped = {"norm": mu["w"], "w": mu["norm"], "sub": mu["sub"]}
    with pytest.raises(ValueError, match="/norm is nested or shaped unlike"):
        TA.adamw_update(cfg, p, grads, {"mu": swapped, "nu": swapped,
                                        "step": torch.tensor(1)})
    assert all(torch.equal(x, y) for x, y in zip(TA.leaves(p),
                                                 TA.leaves(params)))


def test_remat_train_step_equal():
    """``RunFlags(remat=True)`` changes what is kept, not what is computed:
    one Jamba step (attention, Mamba and MoE layers) gives the same loss,
    metrics and weights bit for bit."""
    cfg, _, npp = _model("jamba-1.5-large-398b")
    batch = _batch(cfg, S=64)
    out = []
    for remat in (False, True):
        tc = TT.TrainConfig(dtype=torch.float32,
                            flags=M.RunFlags(remat=remat))
        lm = M.from_reference(npp, cfg, device="cpu")
        lm, _, met = TT.make_train_step(cfg, tc)(lm, TA.adamw_init(lm),
                                                 batch)
        out.append((met, [p.detach() for p in lm.parameters()]))
    (ma, pa), (mb, pb) = out
    assert {k: float(v) for k, v in ma.items()} == {
        k: float(v) for k, v in mb.items()}
    assert all(torch.equal(a, b) for a, b in zip(pa, pb))


def test_trainer_lowers_loss():
    """JAX's ``test_loss_decreases_tiny_model`` on the port's ``Trainer``
    (reduced smollm, its own seeded weights, f32, lr 3e-3)."""
    cfg = TC.get_config("smollm-135m").reduced()
    dc = tpipe.DataConfig(seq_len=64, global_batch=8, seed=0)
    tc = TT.TrainConfig(steps=30, warmup=5, log_every=10,
                        dtype=torch.float32, optim=TA.AdamWConfig(lr=3e-3))
    tr = TT.Trainer(cfg, tc, tpipe.synthetic_stream(cfg, dc), device="cpu")
    tr.run()
    assert [h["step"] for h in tr.history] == [0, 10, 20, 29]
    first, last = tr.history[0]["loss"], tr.history[-1]["loss"]
    assert last < first - 0.5, (first, last)


# -- checkpoints across the packages ----------------------------------------

def _stepped(moments):
    """Reduced smollm weights and an AdamW state after one JAX update."""
    _, _, npp = _model("smollm-135m")
    jp = _jnp(npp)
    g = jax.tree.map(lambda a: jnp.full(a.shape, 0.01, jnp.float32), jp)
    return JA.adamw_update(JA.AdamWConfig(), jp, g,
                           JA.adamw_init(jp, moments))[:2]


def _paths(tree, pre=""):
    """The leaves' paths in order."""
    if isinstance(tree, dict):
        return [q for k, v in tree.items() for q in _paths(v, f"{pre}/{k}")]
    if isinstance(tree, list):
        return [q for i, v in enumerate(tree) for q in _paths(v, f"{pre}/{i}")]
    return [pre]


def _bits(a):
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype.itemsize == 2 else a


@pytest.mark.parametrize("moments", ["f32", "bf16"])
def test_port_checkpoint_restores_in_jax(tmp_path, moments):
    cfg, _, _ = _model("smollm-135m")
    jp, js = _stepped(moments)
    lm = M.from_reference(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    opt = {"mu": M.unstack_reference(jax.tree.map(np.asarray, js["mu"]),
                                     cfg, "cpu"),
           "nu": M.unstack_reference(jax.tree.map(np.asarray, js["nu"]),
                                     cfg, "cpu"),
           "step": torch.tensor(int(js["step"]), dtype=torch.int32)}
    TCk.save_checkpoint(str(tmp_path), lm, opt, step=1)
    params, o2, step = JCk.load_checkpoint(str(tmp_path), like=jp)
    assert step == 1 and int(o2["step"]) == 1
    for a, b in zip(jax.tree.leaves(params), jax.tree.leaves(jp)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    for part in ("mu", "nu"):
        got = jax.tree.leaves(o2[part])
        want = jax.tree.leaves(js[part])
        assert len(got) == len(want)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(_bits(a), _bits(b))


@pytest.mark.parametrize("moments", ["f32", "bf16"])
def test_jax_checkpoint_loads_in_port(tmp_path, moments):
    cfg, _, _ = _model("smollm-135m")
    jp, js = _stepped(moments)
    JCk.save_checkpoint(str(tmp_path), jp, js, step=1)
    lm, opt, step = TCk.load_checkpoint(str(tmp_path), cfg, device="cpu")
    assert step == 1 and opt["step"].dtype == torch.int32
    assert int(opt["step"]) == 1
    for got, want in ((lm, jp), (opt["mu"], js["mu"]), (opt["nu"], js["nu"])):
        got = M.to_reference(got, cfg)
        flat = jax.tree.leaves(want)
        assert len(jax.tree.leaves(got)) == len(flat)
        for a, b in zip(jax.tree.leaves(got), flat):
            np.testing.assert_array_equal(_bits(a), _bits(b))
    dtype = torch.bfloat16 if moments == "bf16" else torch.float32
    assert all(t.dtype == dtype for t in TA.leaves(opt["mu"]))
    # the moments listed as the weights, not in the file's sorted order
    assert _paths(opt["mu"]) == _paths(opt["nu"]) == _paths(lm.tree())


def test_launcher_trains_and_checkpoints(tmp_path, capsys):
    """``python -m repro_torch.launch.train`` on the CPU: f32, the loss
    logged, a checkpoint at the last step that restores the weights."""
    last = launch_train.main(["--arch", "smollm-135m", "--reduced",
                              "--steps", "4", "--batch", "2", "--seq", "32",
                              "--ckpt", str(tmp_path), "--device", "cpu"])
    out = capsys.readouterr().out
    assert "devices=1 (cpu)" in out and np.isfinite(last["loss"])
    cfg = TC.get_config("smollm-135m").reduced()
    lm, opt, step = TCk.load_checkpoint(str(tmp_path), cfg, device="cpu")
    assert step == 4 and int(opt["step"]) == 4
    assert all(t.dtype == torch.float32 for t in lm.parameters())
    assert dataclasses.asdict(lm.cfg) == dataclasses.asdict(cfg)
