"""The port's mesh layer (``repro_torch.distribution``,
``data.pipeline.make_batch_specs``) against the JAX package's, on the CPU.

The sharding specs are compared exactly, for every architecture at its
full published size, on the production meshes ((16, 16) and (2, 16, 16),
JAX's ``AbstractMesh``; the port's rules take the same axis sizes) with
``fsdp`` and ``pure_dp`` both ways: every parameter and AdamW moment, the
batch of every input shape and the decode caches of every input shape
(long_500k's sequence sharding included).  The port holds one dict per
layer where JAX stacks a period's layers on a leading axis, so layer i's
spec is held against JAX's spec of the stacked ``pos{i % period}`` leaf
without its first entry (the caches' batch is the port's axis 0, JAX's
axis 1).  The port's leaves are fake tensors (``FakeTensorMode``: shapes,
nothing allocated), JAX's come from ``jax.eval_shape``.

The constraints are the identity on plain tensors and without a mesh, and
a reduced model's loss is bit for bit the same with the restored calls as
with each replaced by the identity.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh, NamedSharding
from torch._subclasses.fake_tensor import FakeTensorMode

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import repro.configs as JC  # noqa: E402
from repro.data import pipeline as JP  # noqa: E402
from repro.distribution import sharding as JS  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models.config import INPUT_SHAPES  # noqa: E402
from repro.optim import adamw as JA  # noqa: E402

from repro_torch import configs as TC  # noqa: E402
from repro_torch.data import pipeline as TP  # noqa: E402
from repro_torch.distribution import constraints as C  # noqa: E402
from repro_torch.distribution import sharding as S  # noqa: E402
from repro_torch.models import model as M, moe, transformer  # noqa: E402
from repro_torch.models.config import INPUT_SHAPES as T_SHAPES  # noqa: E402
from repro_torch.optim import adamw as TA  # noqa: E402

MESHES = {"single": ((16, 16), ("data", "model")),
          "multi": ((2, 16, 16), ("pod", "data", "model"))}
FLAGS = [(False, False), (True, False), (False, True), (True, True)]
_CACHE = {}


def _jax_mesh(kind):
    shape, names = MESHES[kind]
    return AbstractMesh(shape, names)


def _axes(kind):
    shape, names = MESHES[kind]
    return dict(zip(names, shape))


def _key(k):
    return str(getattr(k, "key", getattr(k, "idx", k)))


def _jax_specs(tree):
    """{path: (spec padded to the leaf's rank)} of a NamedSharding tree."""
    flat = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, NamedSharding))[0]
    return {tuple(_key(k) for k in path): tuple(sh.spec)
            for path, sh in flat}


def _port_flat(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _port_flat(v, path + (k,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _port_flat(v, path + (i,))
    else:
        yield path, tree


def _padded(spec, n):
    return tuple(spec) + (None,) * (n - len(spec))


def _hold(cfg, port_specs, port_leaves, jax_specs, stacked_lead=1,
          prefix_len=0):
    """Every port spec equals JAX's for its counterpart; returns the number
    of leaves held."""
    periods = {"blocks": len(cfg.period), "enc_blocks": 1}
    leaves = dict(_port_flat(port_leaves))
    n = 0
    for path, spec in _port_flat(port_specs):
        nd = len(leaves[path].shape)
        head, rest = path[:prefix_len], path[prefix_len:]
        if rest and rest[0] in periods:
            jpath = head + (rest[0], f"pos{rest[1] % periods[rest[0]]}") \
                + tuple(str(k) for k in rest[2:])
            want = _padded(jax_specs[jpath], nd + stacked_lead)[stacked_lead:]
        elif isinstance(rest[0], int):        # a cache list: layer i
            P = len(cfg.period)
            jpath = (f"pos{rest[0] % P}",) + tuple(str(k) for k in rest[1:])
            want = _padded(jax_specs[jpath], nd + stacked_lead)[stacked_lead:]
        else:
            jpath = tuple(str(k) for k in path)
            want = _padded(jax_specs[jpath], nd)
        assert _padded(spec, nd) == want, (cfg.name, path, spec, want)
        n += 1
    assert n == len(jax.tree_util.tree_leaves(jax_specs)) or n > 0
    return n


def _trees(arch):
    """(cfg, jcfg, port param tree and AdamW state (fake), JAX param
    shapes)."""
    if arch not in _CACHE:
        cfg, jcfg = TC.get_config(arch), JC.get_config(arch)
        with FakeTensorMode():
            tree = M.init_lm(cfg, 0, device="cpu").tree()
            opt = TA.adamw_init(tree)
        jshapes = jax.eval_shape(
            lambda: JM.init_lm(jax.random.PRNGKey(0), jcfg))
        _CACHE[arch] = (cfg, jcfg, tree, opt, jshapes)
    return _CACHE[arch]


@pytest.mark.parametrize("kind", list(MESHES))
@pytest.mark.parametrize("arch", list(JC.ARCHS))
def test_param_and_opt_specs_equal_jax(arch, kind):
    cfg, jcfg, tree, opt, jshapes = _trees(arch)
    mesh, axes = _jax_mesh(kind), _axes(kind)
    n_leaves = len(jax.tree_util.tree_leaves(jshapes))
    jopt = jax.eval_shape(JA.adamw_init, jshapes)
    for fsdp, pure_dp in FLAGS:
        ps = S.param_specs(axes, tree, fsdp=fsdp, pure_dp=pure_dp)
        js = _jax_specs(JS.param_shardings(mesh, jshapes, fsdp=fsdp,
                                           pure_dp=pure_dp))
        held = _hold(cfg, ps, tree, js)
        # the port has a leaf per layer where JAX has one per period slot
        assert held == sum(1 for _ in _port_flat(tree)) >= n_leaves
        osp = S.opt_specs(axes, opt, fsdp=fsdp, pure_dp=pure_dp)
        jos = _jax_specs(JS.opt_shardings(mesh, jopt, fsdp=fsdp,
                                          pure_dp=pure_dp))
        assert osp["step"] == () and jos[("step",)] == ()
        for part in ("mu", "nu"):
            _hold(cfg, {part: osp[part]}, {part: opt[part]},
                  {k: v for k, v in jos.items() if k[0] == part},
                  prefix_len=1)


def test_zero1_never_wants_the_stacked_axis():
    """JAX's FSDP / ZeRO-1 "largest free dim" could take the stacked
    period axis only if it held >= 8 · data entries divisible by data:
    no configuration has that many periods, so dropping the axis changes
    no choice."""
    for kind in MESHES:
        data = _axes(kind)["data"]
        for arch in JC.ARCHS:
            n = JC.get_config(arch).n_periods
            assert not (n % data == 0 and n >= 8 * data), (arch, n)


def _cache_len(jcfg, shape):
    from repro.data.pipeline import dec_len
    if shape.kind == "prefill":
        return dec_len(jcfg, shape.seq_len)
    if shape.name == "long_500k" and jcfg.sliding_window and \
            not jcfg.has_state_mixer and jcfg.mla is None:
        return jcfg.sliding_window
    return shape.seq_len


@pytest.mark.parametrize("kind", list(MESHES))
@pytest.mark.parametrize("arch", list(JC.ARCHS))
def test_cache_and_batch_specs_equal_jax(arch, kind):
    cfg, jcfg = TC.get_config(arch), JC.get_config(arch)
    mesh, axes = _jax_mesh(kind), _axes(kind)
    seq_sharded = 0
    for name, shape in INPUT_SHAPES.items():
        tshape = T_SHAPES[name]
        for pure_dp in (False, True):
            jb = JP.make_batch_specs(jcfg, shape)
            tb = TP.make_batch_specs(cfg, tshape)
            bs = S.batch_specs(axes, tb, tshape, pure_dp=pure_dp)
            jbs = _jax_specs(JS.batch_shardings(mesh, jb, shape,
                                                pure_dp=pure_dp))
            for k, spec in bs.items():
                assert _padded(spec, tb[k].ndim) == _padded(
                    jbs[(k,)], tb[k].ndim), (arch, name, k)
            if shape.kind == "train":
                continue
            enc = (shape.seq_len if shape.kind != "decode" else 1500) \
                if jcfg.enc_dec else 0
            L = _cache_len(jcfg, shape)
            jc = jax.eval_shape(lambda: JM.make_caches(
                jcfg, shape.global_batch, L, jnp.bfloat16, enc_len=enc))
            tcache = M.make_caches(cfg, shape.global_batch, L,
                                   torch.bfloat16, enc_len=enc,
                                   device="meta")
            cs = S.cache_specs(axes, tcache, tshape, cfg, pure_dp=pure_dp)
            jcs = _jax_specs(JS.cache_shardings(mesh, jc, shape, jcfg,
                                                pure_dp=pure_dp))
            _hold(cfg, cs, tcache, jcs)
            seq_sharded += any(len(s) > 1 and s[1] == "data"
                               for _, s in _port_flat(cs))
    if not cfg.enc_dec and any(m in ("attn", "mla") for m, _ in cfg.period):
        assert seq_sharded      # long_500k: the cache's sequence on "data"


@pytest.mark.parametrize("arch", list(JC.ARCHS))
def test_make_batch_specs_equal_jax(arch):
    cfg, jcfg = TC.get_config(arch), JC.get_config(arch)
    for name, shape in INPUT_SHAPES.items():
        got = TP.make_batch_specs(cfg, T_SHAPES[name])
        want = JP.make_batch_specs(jcfg, shape)
        assert list(got) == list(want)
        for k, v in got.items():
            assert v.device.type == "meta"
            assert tuple(v.shape) == want[k].shape, (arch, name, k)
            assert str(v.dtype).split(".")[-1] == str(want[k].dtype)


def test_placements_round_trip():
    """A spec's DTensor placements and back, on a (2, 3, 4) mesh of a fake
    group (no tensor is made)."""
    import torch.distributed as dist
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import _mesh
    from torch.distributed.tensor import Replicate, Shard
    dryrun.fake_group(24)
    try:
        mesh = _mesh("cpu", (2, 3, 4), ("pod", "data", "model"))
        spec = (("pod", "data"), None, "model")
        pl = S.placements(spec, mesh)
        assert pl == [Shard(0), Shard(0), Shard(2)]
        assert S.spec_of(pl, mesh, 3) == spec
        assert S.placements((None, None), mesh) == [Replicate()] * 3
        assert S.mesh_axes(mesh) == {"pod": 2, "data": 3, "model": 4}
    finally:
        dist.destroy_process_group()
    assert not dist.is_initialized()


def test_constraints_identity_without_mesh():
    x = torch.randn(4, 6, 8)
    assert C.current_mesh() is None
    assert C.batch_axes() is None and C.model_axis_size() == 0
    assert C.constrain(x, "data", None) is x
    assert C.constrain_batch_dim(x) is x
    assert C.whole(x) is x and C.dp_size() == 1
    assert torch.equal(C.sum_all(x), x.sum())
    C.set_dp_axes(("pod", "data", "model"))
    try:
        assert C.batch_axes() is None and C.constrain_batch_dim(x) is x
    finally:
        C.set_dp_axes(None)


def test_constraints_identity_on_plain_tensors_under_a_mesh():
    """Under an ambient mesh a plain tensor passes every constraint as it
    is, and the axis queries read the mesh."""
    import torch.distributed as dist
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import _mesh
    dryrun.fake_group(8)
    try:
        mesh = _mesh("cpu", (2, 4), ("data", "model"))
        x = torch.randn(4, 6, 8)
        with C.use_mesh(mesh):
            assert C.batch_axes() == "data" and C.model_axis_size() == 4
            assert C.constrain(x, "data") is x
            assert C.constrain_batch_dim(x) is x and C.whole(x) is x
            C.set_dp_axes(("pod", "data", "model"))
            try:
                assert C.batch_axes() == ("data", "model")
                assert C.model_axis_size() == 0 and C.dp_size() == 8
            finally:
                C.set_dp_axes(None)
        assert C.current_mesh() is None
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("arch", ["smollm-135m", "rwkv6-7b", "grok-1-314b",
                                  "deepseek-v2-236b", "qwen2-vl-2b"])
def test_restored_constraints_change_nothing(arch, monkeypatch):
    """A reduced model's loss and gradients with the restored
    ``constrain_batch_dim`` / ``whole`` calls, bit for bit the same as with
    each replaced by the identity (no mesh)."""
    cfg = TC.get_config(arch).reduced()
    lm = M.init_lm(cfg, 0, device="cpu")
    batch = next(TP.synthetic_stream(cfg, TP.DataConfig(seq_len=16,
                                                        global_batch=2)))

    def run():
        lm.requires_grad_()
        loss, _ = M.forward_train(lm, cfg, batch, dtype=torch.float32)
        grads = torch.autograd.grad(loss, list(lm.parameters()),
                                    allow_unused=True,
                                    materialize_grads=True)
        return loss.detach(), grads

    with_calls = run()
    for mod in (M, transformer, moe):
        monkeypatch.setattr(mod, "constrain_batch_dim", lambda x, b=0: x)
    from repro_torch.models import layers, ssm
    for mod in (layers, ssm):
        monkeypatch.setattr(mod, "whole", lambda w: w)
    without = run()
    assert torch.equal(with_calls[0], without[0])
    assert all(torch.equal(a, b) for a, b in zip(with_calls[1], without[1]))


def test_meshes_clamp_as_jax():
    """``make_host_mesh`` clamps as JAX's ``make_host_mesh`` does, over the
    ranks of the process group (a fake one of 8); the production meshes
    over fake groups of 256 and 512."""
    import torch.distributed as dist
    from repro_torch.launch import dryrun, mesh as lmesh
    from repro_torch.launch.train import make_launch_mesh
    dryrun.fake_group(8)
    try:
        for (model, data), want in [((4, 8), (2, 4)), ((16, 1), (1, 8)),
                                    ((2, 2), (2, 2)), ((1, 1), (1, 1))]:
            m = lmesh.make_host_mesh(model, data, device="cpu")
            assert S.mesh_axes(m) == {"data": want[0], "model": want[1]}
        assert S.mesh_axes(make_launch_mesh("cpu")) == {"data": 1,
                                                         "model": 8}
    finally:
        dist.destroy_process_group()
    for world, multi, want in [(256, False, {"data": 16, "model": 16}),
                               (512, True, {"pod": 2, "data": 16,
                                            "model": 16})]:
        dryrun.fake_group(world)
        try:
            m = lmesh.make_production_mesh(multi_pod=multi, device="cpu")
            assert S.mesh_axes(m) == want
            assert S.mesh_axes(make_launch_mesh("cpu")) == want
        finally:
            dist.destroy_process_group()
    assert (lmesh.PEAK_FLOPS_BF16, lmesh.HBM_BW, lmesh.NVLINK_BW,
            lmesh.CHIP_HBM_BYTES) == (989e12, 3.35e12, 450e9, 80e9)
