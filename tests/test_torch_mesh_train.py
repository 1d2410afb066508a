"""Training on a ("data", "model") mesh: two gloo ranks on the CPU against
the port's one-device step and the JAX package's jitted step.

One pair of ranks is spawned (one torch thread each), and the references
are computed while it trains.  It
trains reduced smollm-135m (dense), rwkv6-7b (SSM: the WKV recurrence on
each rank's batch rows and heads) and grok-1 (MoE: routing and dispatch on
each rank's rows, its experts or their hidden width split over the model
axis) at data=2 (pure data parallel, weights replicated) and at model=2
(tensor parallel, the rules' placements), 2 steps each, f32, from JAX's
``init_lm`` weights, through ``launch.train.place`` and
``make_train_step(..., mesh)``, and saves a checkpoint on the mesh (rank 0
writes what every rank gathered).

Tiers are ``tests/test_torch_train.py``'s for one train step: the loss,
accuracy and gradient norm to rtol 1e-5; every first moment (0.1 · clip ·
g) to its gradient tier, 1e-5 · max(1, max |g|); the weights to rtol 1e-4,
atol 1e-5, except where the first moment lies within 100 eps of 0 (AdamW's
first update lr · g / (|g| + eps) turns there on the gradient's last bits),
held to 2 lr.  Those weights' ±lr differences then move the second step's
gradients, so the second step is held by its loss and gradient norm (rtol
1e-5) alone.  The one-device port is held both steps, JAX's step
(microbatches=2 for the dense and SSM data-parallel runs: two halves, as
the two ranks' rows; see ``_jax_mb``) the first.  The checkpoint loads bit for bit in both packages
as the weights the mesh gathered.  The WKV wrapper is called per rank as
often as on one device (2 layers: 2 calls a step).  At model=2 each model
also prefills a prompt and decodes two tokens with its caches placed by
``cache_specs`` (``prefill`` and ``decode_step`` under DTensor
propagation, grok-1's decode on the MoE gather path), the logits within
atol 1e-4 of one device's (the serving tier of
``tests/test_torch_models.py``), and the accuracy, in bf16 with every
logit of a row tied across the split vocabulary, is one device's: argmax's
first index.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import repro.configs as JC  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.optim import adamw as JA  # noqa: E402
from repro.train import checkpoint as JCk, trainer as JT  # noqa: E402

from repro_torch import configs as TC  # noqa: E402
from repro_torch.data import pipeline as tpipe  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.optim import adamw as TA  # noqa: E402
from repro_torch.train import checkpoint as TCk, trainer as TT  # noqa: E402

ARCHS = ["smollm-135m", "rwkv6-7b", "grok-1-314b"]
SHAPES = [(2, 1), (1, 2)]          # (data, model)
JOBS = [(a, s) for a in ARCHS for s in SHAPES]
SERVE = ["smollm-135m", "rwkv6-7b", "grok-1-314b"]   # at model=2
B, S, STEPS, DECODE = 4, 32, 2, 2


def _tc(mb=1):
    return TT.TrainConfig(dtype=torch.float32, microbatches=mb, warmup=2,
                          steps=10)


def _weights(arch):
    """JAX's reduced ``init_lm`` weights as numpy, in its layout."""
    jcfg = JC.get_config(arch).reduced()
    return jax.tree.map(np.asarray, JM.init_lm(jax.random.PRNGKey(0), jcfg))


def _batches(cfg):
    dc = tpipe.DataConfig(seq_len=S, global_batch=B, seed=3)
    it = tpipe.synthetic_stream(cfg, dc)
    return [next(it) for _ in range(STEPS)]


def _worker(rank, port, npps, ckpt_root, q):
    torch.set_num_threads(1)
    from repro_torch import kernels
    from repro_torch.distribution.constraints import set_dp_axes
    from repro_torch.launch.mesh import init_ranks
    from repro_torch.launch.train import make_launch_mesh, place
    import torch.distributed as dist

    os.environ.update(RANK=str(rank), WORLD_SIZE="2",
                      MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    init_ranks("cpu")
    calls = {"n": 0}
    wkv = kernels.rwkv6_autograd

    def counted(*a):
        calls["n"] += 1
        return wkv(*a)

    kernels.rwkv6_autograd = counted
    try:
        for arch, shape in JOBS:
            cfg = TC.get_config(arch).reduced()
            mesh = make_launch_mesh("cpu", shape)
            pure_dp = shape[1] == 1
            set_dp_axes(("pod", "data", "model") if pure_dp else None)
            lm = M.from_reference(npps[arch], cfg, device="cpu")
            params, opt = place(lm, TA.adamw_init(lm), mesh, pure_dp=pure_dp)
            step = TT.make_train_step(cfg, _tc(), mesh, pure_dp)
            out = {"metrics": [], "weights": [], "mu": [], "calls": []}
            for b in _batches(cfg):
                calls["n"] = 0
                params, opt, met = step(params, opt, b)
                out["calls"].append(calls["n"])
                out["metrics"].append({k: float(TT.host_value(v))
                                       for k, v in met.items()})
                out["weights"].append(M.to_reference(params, cfg))
                out["mu"].append(M.to_reference(opt["mu"], cfg))
            path = os.path.join(ckpt_root, f"{arch}_{shape[0]}x{shape[1]}")
            TCk.save_checkpoint(path, params, opt, step=STEPS)
            set_dp_axes(None)
            dist.barrier()
            if rank == 0:
                q.put(((arch, shape), out))
        for arch in SERVE:
            logits = _serve(arch, npps[arch], make_launch_mesh("cpu", (1, 2)))
            if rank == 0:
                q.put(((arch, "serve"), logits))
        acc = _tie_acc(npps["smollm-135m"], make_launch_mesh("cpu", (1, 2)))
        if rank == 0:
            q.put(("tie", acc))
    finally:
        dist.destroy_process_group()
        if rank == 0:
            q.put(None)


def _serve(arch, npp, mesh=None):
    """Prefill a prompt and decode ``DECODE`` tokens (f32, the prompt's
    last tokens fed back) on ``mesh`` (weights, caches and tokens placed
    by the rules) or on one device; the logits of each call."""
    from repro_torch.distribution.constraints import use_mesh
    from repro_torch.distribution.sharding import (batch_specs, cache_specs,
                                                   distribute, mesh_axes)
    from repro_torch.launch.train import place
    from repro_torch.models.config import InputShape
    cfg = TC.get_config(arch).reduced()
    f32 = torch.float32
    tokens = torch.as_tensor(_batches(cfg)[0]["tokens"])
    lm = M.from_reference(npp, cfg, device="cpu")
    caches = M.make_caches(cfg, B, S + DECODE, f32, device="cpu")
    steps = [tokens[:, S - DECODE + t:S - DECODE + t + 1]
             for t in range(DECODE)]
    if mesh is None:
        logits, caches = M.prefill(lm, cfg, {"tokens": tokens}, caches,
                                   dtype=f32)
        out = [logits]
        for t, tok in enumerate(steps):
            logits, caches = M.decode_step(lm, cfg, caches, tok, S + t,
                                           dtype=f32)
            out.append(logits)
        return [o.numpy() for o in out]
    axes = mesh_axes(mesh)
    params, _ = place(lm, None, mesh)
    caches = distribute(caches, cache_specs(
        axes, caches, InputShape("serve", S, B, "decode"), cfg), mesh)

    def placed(t):
        return distribute({"tokens": t}, batch_specs(
            axes, {"tokens": t}), mesh)["tokens"]

    with use_mesh(mesh), torch.no_grad():
        logits, caches = M.prefill(params, cfg, {"tokens": placed(tokens)},
                                   caches, dtype=f32)
        out = [TT.host_value(logits)]
        for t, tok in enumerate(steps):
            logits, caches = M.decode_step(params, cfg, caches, placed(tok),
                                           S + t, dtype=f32)
            out.append(TT.host_value(logits))
    return [o.numpy() for o in out]


def _tie_acc(npp, mesh=None):
    """``chunked_ce_loss``'s accuracy in bf16 where every logit of a row
    ties (a zero residual stream), on ``mesh`` (the vocab split on
    "model") or on one device.  The targets are 0, 1 (a tie in the first
    rank's slice), V/2 and V - 1 (in the second's): argmax's first index,
    0, is the only hit."""
    from torch.distributed.tensor import Replicate, distribute_tensor
    from repro_torch.distribution.constraints import use_mesh
    from repro_torch.launch.train import place
    cfg = TC.get_config("smollm-135m").reduced()
    bf16, V = torch.bfloat16, cfg.vocab
    lm = M.from_reference(npp, cfg, device="cpu")
    tc = torch.tensor([0, 1, V // 2, V - 1] * (S // 4)).repeat(B, 1)
    x = torch.zeros(B, S, cfg.d_model, dtype=bf16)
    if mesh is None:
        _, met = M.chunked_ce_loss(M.cast_params(lm, bf16), cfg, x, tc,
                                   M.RunFlags())
        return float(met["acc"])
    params, _ = place(lm, None, mesh)
    with use_mesh(mesh), torch.no_grad():
        x = distribute_tensor(x, mesh, [Replicate(), Replicate()])
        logits = M._head(M.cast_params(params, bf16), cfg, x)
        assert logits.placements[1].is_shard(2)     # the vocab is split
        _, met = M.chunked_ce_loss(M.cast_params(params, bf16), cfg, x, tc,
                                   M.RunFlags())
        return float(TT.host_value(met["acc"]))


def _one_device(arch, npp):
    cfg = TC.get_config(arch).reduced()
    lm = M.from_reference(npp, cfg, device="cpu")
    opt = TA.adamw_init(lm)
    step = TT.make_train_step(cfg, _tc())
    out = {"metrics": [], "weights": [], "mu": []}
    for b in _batches(cfg):
        lm, opt, met = step(lm, opt, b)
        out["metrics"].append({k: float(v) for k, v in met.items()})
        out["weights"].append(M.to_reference(lm, cfg))
        out["mu"].append(M.to_reference(opt["mu"], cfg))
    return out


def _jax_first_step(arch, npp, mb):
    jcfg = JC.get_config(arch).reduced()
    jtc = JT.TrainConfig(dtype=jnp.float32, microbatches=mb, warmup=2,
                         steps=10)
    jp = jax.tree.map(jnp.asarray, npp)
    b = jax.tree.map(jnp.asarray, _batches(TC.get_config(arch).reduced())[0])
    jp, js, jm = jax.jit(JT.make_train_step(jcfg, jtc))(
        jp, JA.adamw_init(jp), b)
    return {"metrics": {k: float(v) for k, v in jm.items()},
            "weights": jax.tree.map(np.asarray, jp),
            "mu": jax.tree.map(np.asarray, js["mu"])}


def _hold(got_m, want_m, got_w, want_w, got_mu, want_mu, lr, weights=True,
          what=""):
    """The train step's tiers (module docstring); the first moment's is
    the gradient tier of ``tests/test_torch_train.py`` (1e-5 · max(1,
    max |g|)) carried to mu = 0.1 · clip · g."""
    for k in ("loss", "grad_norm", "lr_scale") + (("acc",) if weights
                                                  else ()):
        np.testing.assert_allclose(got_m[k], want_m[k], rtol=1e-5,
                                   err_msg=f"{what} {k}")
    if not weights:
        return
    clip = min(1.0, 1.0 / (want_m["grad_norm"] + 1e-9))
    for a, b, m, wm in zip(*(jax.tree.leaves(t) for t in (
            got_w, want_w, got_mu, want_mu))):
        np.testing.assert_allclose(
            m, wm, rtol=0, atol=1e-5 * max(float(np.abs(wm).max()),
                                           0.1 * clip), err_msg=what)
        tiny = np.abs(wm) < 0.1 * 100 * TA.AdamWConfig().eps
        np.testing.assert_allclose(a[~tiny], b[~tiny], rtol=1e-4, atol=1e-5)
        assert np.abs(a - b)[tiny].max(initial=0) <= 2 * lr


def _jax_mb(arch, shape) -> int:
    """JAX's microbatches for a mesh run: 2 at data=2 (each half of the rows
    a rank's), except for the MoE model, whose load-balance loss takes its
    means over the whole batch on the mesh (as on one device) and over
    each microbatch in JAX's split step."""
    return 2 if shape[1] == 1 and arch != "grok-1-314b" else 1


def _spawn(npps, root):
    """Start the two ranks; returns (processes, queue)."""
    from repro_torch.launch.mesh import _free_port
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=_worker, args=(r, port, npps, root, q))
             for r in range(2)]
    for p in procs:
        p.start()
    return procs, q


def _collect(procs, q):
    runs = {}
    while True:
        item = q.get(timeout=600)
        if item is None:
            break
        runs[item[0]] = item[1]
    for p in procs:
        p.join(timeout=60)
    assert all(p.exitcode == 0 for p in procs), [p.exitcode for p in procs]
    return runs


def _hold_checkpoint(runs, npps, root, shape):
    """grok-1's checkpoint saved on the mesh loads bit for bit, in the port
    and in JAX, as the weights and moments the mesh gathered."""
    arch = "grok-1-314b"
    cfg = TC.get_config(arch).reduced()
    path = os.path.join(root, f"{arch}_{shape[0]}x{shape[1]}")
    want = runs[(arch, shape)]["weights"][-1]
    lm, opt, step = TCk.load_checkpoint(path, cfg, device="cpu")
    assert step == STEPS and int(opt["step"]) == STEPS
    for a, b in zip(jax.tree.leaves(M.to_reference(lm, cfg)),
                    jax.tree.leaves(want)):
        np.testing.assert_array_equal(a, b)
    jp, jo, jstep = JCk.load_checkpoint(path, like=npps[arch])
    assert jstep == STEPS
    for a, b in zip(jax.tree.leaves(jp), jax.tree.leaves(want)):
        np.testing.assert_array_equal(np.asarray(a), b)
    mu = runs[(arch, shape)]["mu"][-1]
    for a, b in zip(jax.tree.leaves(M.to_reference(opt["mu"], cfg)),
                    jax.tree.leaves(mu)):
        np.testing.assert_array_equal(a, b)


def test_mesh_training_matches_one_device_and_jax(tmp_path):
    """Every (arch, mesh) of ``JOBS``: both steps against the one-device
    port, the first against JAX's step; the WKV wrapper's calls per rank;
    grok-1's mesh checkpoints in both packages.  The references are
    computed while the ranks train."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        npps = {a: _weights(a) for a in ARCHS}
        procs, q = _spawn(npps, str(tmp_path))
        try:
            one = {a: _one_device(a, npps[a]) for a in ARCHS}
            jx = {(a, s): _jax_first_step(a, npps[a], mb=_jax_mb(a, s))
                  for a, s in JOBS}
            served = {a: _serve(a, npps[a]) for a in SERVE}
        finally:
            runs = _collect(procs, q)
    finally:
        torch.set_num_threads(threads)
    for arch, shape in JOBS:
        got, ref = runs[(arch, shape)], one[arch]
        lr = TA.AdamWConfig().lr * got["metrics"][0]["lr_scale"]
        for i in range(STEPS):
            _hold(got["metrics"][i], ref["metrics"][i], got["weights"][i],
                  ref["weights"][i], got["mu"][i], ref["mu"][i], lr,
                  weights=i == 0, what=f"{arch} {shape} step {i + 1}")
        j = jx[(arch, shape)]
        _hold(got["metrics"][0], j["metrics"], got["weights"][0],
              j["weights"], got["mu"][0], j["mu"], lr,
              what=f"{arch} {shape} against JAX")
        if arch == "rwkv6-7b":   # the WKV call once a layer a step, a rank
            assert got["calls"] == [2] * STEPS
    for shape in SHAPES:
        _hold_checkpoint(runs, npps, str(tmp_path), shape)
    for arch in SERVE:      # prefill and decode on the model mesh
        for got, want in zip(runs[(arch, "serve")], served[arch]):
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-4,
                                       err_msg=arch)
    # ties at the row's max across the split vocab score as argmax does
    assert runs["tie"] == _tie_acc(npps["smollm-135m"]) == 0.25


def _four_rank_worker(rank, port, q):
    torch.set_num_threads(1)
    from repro_torch.distribution.constraints import set_dp_axes
    from repro_torch.launch.mesh import init_ranks
    from repro_torch.launch.train import make_launch_mesh, place
    import torch.distributed as dist
    os.environ.update(RANK=str(rank), WORLD_SIZE="4",
                      MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    init_ranks("cpu")
    try:
        cfg = TC.get_config("smollm-135m").reduced()
        mesh = make_launch_mesh("cpu", (4, 1))
        set_dp_axes(("pod", "data", "model"))
        lm = M.init_lm(cfg, 0, device="cpu")
        params, opt = place(lm, TA.adamw_init(lm), mesh, pure_dp=True)
        step = TT.make_train_step(cfg, _bf16_tc(), mesh, True)
        losses = []
        for b in _batches(cfg):
            params, opt, met = step(params, opt, b)
            losses.append(float(TT.host_value(met["loss"])))
        if rank == 0:
            q.put(losses)
    finally:
        dist.destroy_process_group()


def _bf16_tc():
    return TT.TrainConfig(dtype=torch.bfloat16, warmup=2, steps=10,
                          optim=TA.AdamWConfig(lr=1e-3))


def test_four_ranks_bf16_update_stays_finite():
    """Four gloo ranks, data=4, bf16 compute over f32 masters (a layout
    where AdamW once turned weights NaN: the gradients' partial sums over
    both mesh axes met the moments' ZeRO-1 split in its in-place
    arithmetic; they are now reduced into the moments' layout first):
    the losses finite, the first step's (the same weights, sums in
    another order) within 1e-4 of one device's, the second's (after an
    update whose tiny-gradient entries turn on bf16 gradients' last bits)
    within 1e-3."""
    from repro_torch.launch.mesh import _free_port
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=_four_rank_worker, args=(r, port, q))
             for r in range(4)]
    for p in procs:
        p.start()
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        cfg = TC.get_config("smollm-135m").reduced()
        lm = M.init_lm(cfg, 0, device="cpu")
        step, opt = TT.make_train_step(cfg, _bf16_tc()), TA.adamw_init(lm)
        want = []
        for b in _batches(cfg):
            lm, opt, met = step(lm, opt, b)
            want.append(float(met["loss"]))
        got = q.get(timeout=300)
    finally:
        torch.set_num_threads(threads)
        for p in procs:
            p.join(timeout=60)
    assert all(p.exitcode == 0 for p in procs)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got[0], want[0], rtol=1e-4)
    np.testing.assert_allclose(got[1], want[1], rtol=1e-3)
