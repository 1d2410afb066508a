"""The port's dry-run planner (``repro_torch.launch.dryrun``,
``repro_torch.analysis.roofline``) against the JAX package's, on the CPU.

``case_policy`` and ``model_flops_estimate`` equal JAX's for every
architecture and input shape.  Reduced models are planned on a fake
process group of 16 ranks ((4, 4) mesh) and of 256 (the production
(16, 16) mesh): each case plans without error, its per-device argument
bytes (weights, moments, batch, caches) equal the bytes JAX's specs give
the same leaves on the same mesh, and the fake group is gone after it.
whisper's long_500k is skipped with JAX's reason.  The kernels' operators
give their outputs' shapes on fake tensors and count the FLOPs
``chip_smoke.py``'s bounds count; on real tensors the forward ones
compute what the wrappers compute.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import AbstractMesh, NamedSharding

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

_flags = os.environ.get("XLA_FLAGS")
from repro.launch import dryrun as JD  # noqa: E402  (sets XLA_FLAGS)
if _flags is None:      # the placeholders are the JAX dry-run's alone
    os.environ.pop("XLA_FLAGS", None)
else:
    os.environ["XLA_FLAGS"] = _flags

import repro.configs as JC  # noqa: E402
from repro.analysis import roofline as JR  # noqa: E402
from repro.data import pipeline as JP  # noqa: E402
from repro.distribution import sharding as JS  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models.config import INPUT_SHAPES  # noqa: E402
from repro.optim import adamw as JA  # noqa: E402

from repro_torch import configs as TC, kernels  # noqa: E402
from repro_torch.analysis import roofline as TR  # noqa: E402
from repro_torch.kernels import _ops  # noqa: E402
from repro_torch.launch import dryrun as TD  # noqa: E402
from repro_torch.launch.mesh import _mesh  # noqa: E402
from repro_torch.models.config import INPUT_SHAPES as T_SHAPES  # noqa: E402


def _dtype_name(dt):
    return str(dt).split(".")[-1].replace("'>", "").split("'")[-1]


@pytest.mark.parametrize("arch", list(JC.ARCHS))
def test_case_policy_and_model_flops_equal_jax(arch):
    cfg, jcfg = TC.get_config(arch), JC.get_config(arch)
    for name, shape in INPUT_SHAPES.items():
        got, want = TD.case_policy(cfg, T_SHAPES[name]), JD.case_policy(
            jcfg, shape)
        for field in vars(want):
            a, b = getattr(got, field), getattr(want, field)
            if field == "param_dtype":
                assert _dtype_name(a) == jnp.dtype(b).name, (arch, name)
            else:
                assert a == b, (arch, name, field, a, b)
        assert TR.model_flops_estimate(cfg, T_SHAPES[name]) == \
            JR.model_flops_estimate(jcfg, shape)


def _jax_bytes(tree, shardings, axes):
    """Per-device bytes of ``tree``'s leaves under ``shardings``."""
    total = 0
    for leaf, sh in zip(jax.tree.leaves(tree), jax.tree.leaves(
            shardings, is_leaf=lambda x: isinstance(x, NamedSharding))):
        n = int(np.prod(leaf.shape)) * jnp.dtype(leaf.dtype).itemsize
        for e in sh.spec:
            for a in (e if isinstance(e, tuple) else (e,) if e else ()):
                n //= axes[a]
        total += n
    return total


def _jax_parts(jcfg, shape, pol, mesh_shape, names):
    """JAX's per-device argument bytes by part for one case."""
    axes = dict(zip(names, mesh_shape))
    mesh = AbstractMesh(mesh_shape, names)
    n_dev = int(np.prod(mesh_shape))
    pure_dp = pol.pure_dp and shape.global_batch % n_dev == 0
    pdt = jnp.float32 if _dtype_name(pol.param_dtype) == "float32" \
        else jnp.bfloat16
    ps = jax.eval_shape(lambda: JM.init_lm(jax.random.PRNGKey(0), jcfg, pdt))
    parts = {"params": _jax_bytes(ps, JS.param_shardings(
        mesh, ps, fsdp=pol.fsdp, pure_dp=pure_dp), axes)}
    bs = JP.make_batch_specs(jcfg, shape)
    parts["batch"] = _jax_bytes(bs, JS.batch_shardings(
        mesh, bs, shape, pure_dp=pure_dp), axes)
    if shape.kind == "train":
        os_ = jax.eval_shape(
            lambda p: JA.adamw_init(p, moment_dtype=pol.moment_dtype), ps)
        moments = {"mu": os_["mu"], "nu": os_["nu"]}
        parts["opt"] = _jax_bytes(moments, JS.opt_shardings(
            mesh, moments, fsdp=pol.fsdp, pure_dp=pure_dp), axes)
    else:
        L = (JP.dec_len(jcfg, shape.seq_len) if shape.kind == "prefill"
             else pol.cache_len)
        cs = jax.eval_shape(lambda: JM.make_caches(
            jcfg, shape.global_batch, L, jnp.bfloat16, enc_len=pol.enc_len))
        parts["caches"] = _jax_bytes(cs, JS.cache_shardings(
            mesh, cs, shape, jcfg, pure_dp=pure_dp), axes)
    return parts


@pytest.mark.parametrize("arch,shape_name", [
    ("smollm-135m", "train_4k"), ("grok-1-314b", "decode_32k"),
    ("rwkv6-7b", "prefill_32k"), ("jamba-1.5-large-398b", "long_500k")])
def test_plan_on_16_fake_ranks(arch, shape_name):
    """A reduced model planned on (4, 4) over a fake group of 16 ranks at a
    short sequence: its argument bytes are JAX's for the same leaves."""
    from repro.models.config import InputShape as JShape
    from repro_torch.models.config import InputShape
    cfg, jcfg = TC.get_config(arch).reduced(), JC.get_config(arch).reduced()
    base = T_SHAPES[shape_name]
    shape = InputShape(base.name, 64, 16 if base.global_batch > 1 else 1,
                       base.kind)
    jshape = JShape(shape.name, shape.seq_len, shape.global_batch,
                    shape.kind)
    pol, jpol = TD.case_policy(cfg, shape), JD.case_policy(jcfg, jshape)
    if shape.kind == "decode":
        pol.cache_len = jpol.cache_len = 64
    TD.fake_group(16)
    try:
        mesh = _mesh("cpu", (4, 4), ("data", "model"))
        mode = TR.PlanMode()
        with mode:
            parts = TD.plan_case(cfg, shape, mesh, pol, mode)
        rep = TR.analyze_plan("t", mode, chips=16,
                              arg_bytes=sum(parts.values()))
    finally:
        dist.destroy_process_group()
    assert parts == _jax_parts(jcfg, jshape, jpol, (4, 4),
                               ("data", "model"))
    assert rep.flops > 0 and rep.bytes_accessed > 0 and rep.temp_bytes > 0
    assert rep.fits_hbm and rep.dominant in ("compute", "memory",
                                             "collective")


@pytest.mark.parametrize("arch,shape_name", [("smollm-135m", "decode_32k"),
                                             ("qwen2-vl-2b", "long_500k")])
def test_run_case_on_256_fake_ranks(arch, shape_name):
    """``run_case`` on the production (16, 16) mesh with a reduced model:
    status ok, JAX's argument bytes, and no process group left behind."""
    cfg, jcfg = TC.get_config(arch).reduced(), JC.get_config(arch).reduced()
    rec = TD.run_case(arch, shape_name, "single", verbose=False, cfg=cfg)
    assert not dist.is_initialized()
    assert rec["status"] == "ok", rec.get("error")
    shape = INPUT_SHAPES[shape_name]
    want = _jax_parts(jcfg, shape, JD.case_policy(jcfg, shape), (16, 16),
                      ("data", "model"))
    assert rec["arg_bytes_by_part"] == want
    r = rec["roofline"]
    assert r["arg_bytes"] == sum(want.values())
    assert r["model_flops"] == JR.model_flops_estimate(jcfg, shape)


def test_whisper_long_context_skipped_with_jax_reason():
    rec = TD.run_case("whisper-medium", "long_500k", "multi", verbose=False)
    want = JD.case_policy(JC.get_config("whisper-medium"),
                          INPUT_SHAPES["long_500k"]).skip
    assert rec["status"] == "skipped" and rec["reason"] == want
    assert not dist.is_initialized()


def test_kernel_ops_shapes_and_flops():
    """On fake tensors the wrappers call the operators, whose shapes are
    the wrappers' and whose FLOPs are chip_smoke's operation counts."""
    B, S, H, hd, di, ds = 2, 70, 3, 32, 48, 16
    mode = TR.PlanMode()
    with mode:
        mode.start()
        r = torch.empty(B, S, H, hd, requires_grad=True)
        y, fin = kernels.rwkv6_autograd(r, r, r, r, torch.empty(H, hd))
        y.sum().backward()
        assert y.shape == (B, S, H, hd) and fin.shape == (B, H, hd, hd)
        x = torch.empty(B, S, di)
        ys, hs = kernels.mamba_scan(x, x, torch.empty(di, ds),
                                    torch.empty(B, S, ds),
                                    torch.empty(B, S, ds))
        assert ys.shape == (B, S, di) and hs.shape == (B, di, ds)
        q = torch.empty(B, S, 4, 64)
        o = kernels.attention(q, torch.empty(B, S, 2, 64),
                              torch.empty(B, S, 2, 64), causal=True,
                              window=16)
        assert o.shape == q.shape
    wkv = 5 * B * S * H * hd * (hd + 1)
    pairs = sum(min(i + 1, 16) for i in range(S))
    got = mode.flops_by_op
    assert got["rwkv6"] == wkv and got["rwkv6_vjp"] == 4 * wkv
    assert got["mamba_scan"] == 6 * B * S * di * ds
    assert got["attention"] == 4 * 64 * B * 4 * pairs


def test_kernel_ops_are_fake_only():
    """The operators have fake implementations alone: on real tensors they
    raise, and the wrappers, which real tensors reach, run the plain
    versions on the CPU."""
    g = torch.Generator().manual_seed(0)
    B, S, H, hd = 2, 70, 2, 32
    r, k, v = (torch.randn(B, S, H, hd, generator=g) for _ in range(3))
    w = torch.rand(B, S, H, hd, generator=g) * 0.5 + 0.4
    u = torch.randn(H, hd, generator=g)
    with pytest.raises(NotImplementedError):
        _ops.rwkv6(r, k, v, w, u, None)
    a, b = kernels.rwkv6(r, k, v, w, u), kernels.rwkv6_plain(r, k, v, w, u)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    x = torch.randn(B, S, 24, generator=g)
    d = torch.rand(B, S, 24, generator=g)
    A = -torch.rand(24, 16, generator=g)
    Bs, Cs = (torch.randn(B, S, 16, generator=g) for _ in range(2))
    with pytest.raises(NotImplementedError):
        _ops.mamba_scan(x, d, A, Bs, Cs, None)
    a = kernels.mamba_scan(x, d, A, Bs, Cs)
    b = kernels.mamba_scan_plain(x, d, A, Bs, Cs)
    assert all(torch.equal(p, q) for p, q in zip(a, b))
    q = torch.randn(B, S, 4, 32, generator=g)
    kk = torch.randn(B, S, 2, 32, generator=g)
    with pytest.raises(NotImplementedError):
        _ops.attention(q, kk, kk, True, None)
    assert torch.equal(kernels.attention(q, kk, kk, causal=True),
                       kernels.attention_plain(q, kk, kk, causal=True))


@pytest.mark.parametrize("T,held", [(4, 8), (64, 8), (64, 2)])
def test_traced_moe_gather_counts_the_loop(T, held):
    """A traced MoE gather path runs the real loop's arithmetic: the
    rank's share of the T·K picks (``held`` of the E experts) spread over
    as many of its experts as it can, three matmuls of d × f a pick
    (not JAX's formulation, which gathers (T, K, d, f) weights)."""
    from repro_torch.models import moe
    cfg = TC.get_config("grok-1-314b").reduced()
    E, K = cfg.moe.n_experts, cfg.moe.top_k
    d, f = cfg.d_model, cfg.moe.d_expert
    mode = TR.PlanMode()
    with mode:
        p = {"router": torch.empty(d, E), "we_g": torch.empty(held, d, f),
             "we_u": torch.empty(held, d, f), "we_o": torch.empty(held, f, d)}
        mode.start()
        out = moe._gather(p, cfg, torch.empty(1, T, d), e0=0)
    assert out.shape == (1, T, d)
    picks = -(-T * K * held // E)
    touched = min(held, picks)
    rows = touched * -(-picks // touched)
    assert mode.flops_by_op["mm"] == 2 * T * d * E + 6 * rows * d * f
