"""Serving and training on a ("data", "model") mesh do what the planner
says and what one device and the JAX package compute: two gloo ranks on
the CPU against one device, against the JAX package's ``prefill`` /
``decode_step`` and against ``dryrun.plan_case``.

Two ranks are spawned (one torch thread each).  Reduced smollm-135m
(GQA attention whose one key head the model axis cannot split, so the
caches' head width is split), DeepSeek-V2 (MLA's faithful reconstruct,
MoE on the gather path) and Jamba (Mamba, attention and MoE), from the
JAX package's ``init_lm`` weights, prefill a prompt and decode two tokens
greedily, in f32, through ``chip_smoke.serve_on_mesh``, on mesh (1, 2) at
batch 4 and on mesh (2, 1) at batch 1, where ``cache_specs`` splits the
caches' sequence over the data axis (each rank attends over its own cache
slots and the softmax's statistics are combined across the ranks).
DeepSeek-V2 and Jamba serve again with the weights placed for FSDP (the
largest free dim of each weight split over "data": the MoE experts'
columns on (2, 1)).  On each:

* the collective bytes and counts of each kind that the run issues
  (``roofline.CommTally`` on rank 0) are those ``plan_case`` plans for the
  same prefill and decode step, with the same placement, on a fake group
  of 2;
* every call's logits are within 1e-4 of one device's and of JAX's, fed
  the same tokens (the serving tier of ``tests/test_torch_models.py``);
  the greedy tokens equal one device's, and JAX's argmax except where
  JAX's top two logits lie within 1e-4 of each other.

Two head counts serve on (1, 2) at batch 4 as well: smollm-135m's own 9
query and 3 key heads, which the model axis does not divide (each rank
projects, rotates and attends with every head at half of the prompt's
rows, its output a partial sum reduced across the ranks), and reduced
qwen1.5-110b's 4 and 1 (each rank its 2 query heads against the key
head made whole; a 32-token prompt, so that the prefill's scores outgrow
the keys and values and take that layout).

Four ranks serve on (1, 4) at batch 4 with reduced qwen2-vl-2b at its
own 12 query and 2 key heads and a 32-token prompt (3 query heads a
rank, whose group of 6 reads one key head: each rank attends with its
heads against that key head made whole), held as above; each rank plans
a quarter of one rank's attention FLOPs.

Then each rank routes its all-gathers through c10d
(``launch.mesh.share_card_gathers``, the route for ranks sharing a card,
here on the CPU's kernel) and serves smollm-135m and DeepSeek-V2 again on
both meshes: logits bit for bit and the same collectives, counted alike.

A second pair of ranks trains reduced smollm-135m and grok-1 (MoE) two
steps at data=2 with the weights placed for FSDP (``launch.train.place(...,
fsdp=True)``: each layer's weights gathered where the layer uses them,
``constraints.gather_fsdp``, the head once a step in ``chunked_ce_loss``),
and the 9-head smollm-135m two steps at model=2 (tensor parallel), each
held to the one-device step at the tiers of
``tests/test_torch_mesh_train.py``: the first step's loss, accuracy,
gradient norm (rtol 1e-5), first moments and weights; the second's loss
and gradient norm.
"""

import dataclasses
import os
import queue
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))

import chip_smoke  # noqa: E402
import repro.configs as JC  # noqa: E402
from repro.models import model as JM  # noqa: E402

from repro_torch import configs as TC  # noqa: E402
from repro_torch.data import pipeline as tpipe  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.optim import adamw as TA  # noqa: E402
from repro_torch.train import trainer as TT  # noqa: E402

ARCHS = ["smollm-135m", "deepseek-v2-236b", "jamba-1.5-large-398b"]
ROUTED = ARCHS[:2]
FSDP = ARCHS[1:]
JOBS = [((1, 2), 4), ((2, 1), 1)]      # (data, model), batch
# head counts the model axis of 2 does not divide (smollm-135m's 9 query
# and 3 key heads: each rank attends with every head at half the query
# rows) or divides for the queries only (qwen1.5-110b reduced, 4 and 1:
# each rank its 2 query heads against the one key head)
HEADS = {"smollm-135m:9": ("smollm-135m", {"n_heads": 9, "n_kv": 3}),
         "qwen1.5-110b": ("qwen1.5-110b", {})}
# served on four ranks at (1, 4): 3 query heads a rank, a key head's group
# of 6 spread over two ranks
FOUR = {"qwen2-vl-2b:12": ("qwen2-vl-2b", {"n_heads": 12, "n_kv": 2})}
RUNS = ([(a, s, B, False) for a in ARCHS for s, B in JOBS]
        + [(a, s, B, True) for a in FSDP for s, B in JOBS]
        + [(a, (1, 2), 4, False) for a in HEADS])
S, DECODE = 16, 2
# prompts long enough that the scores outgrow the keys and values, so that
# the query heads split against their key head (``layers._mesh_core``)
# rather than the attention over the caches' split head width
SEQ = {"qwen1.5-110b": 32, "qwen2-vl-2b:12": 32}
F32 = torch.float32
TRAIN = ["smollm-135m", "grok-1-314b"]
# (configuration, mesh, FSDP's placement)
TRAIN_RUNS = [(a, (2, 1), True) for a in TRAIN] + [
    ("smollm-135m:9", (1, 2), False)]
TRAIN_B, TRAIN_S, STEPS = 4, 32, 2


def _configs(key):
    """(JAX's, the port's) reduced configuration of ``key``: an
    architecture, or a name of :data:`HEADS` (its head counts replaced)."""
    arch, over = {**HEADS, **FOUR}.get(key, (key, {}))
    return (dataclasses.replace(JC.get_config(arch).reduced(), **over),
            dataclasses.replace(TC.get_config(arch).reduced(), **over))


def _weights(arch):
    """JAX's reduced ``init_lm`` weights as numpy, in its layout."""
    jcfg = _configs(arch)[0]
    return jax.tree.map(np.asarray, JM.init_lm(jax.random.PRNGKey(0), jcfg))


def _prompt(arch, cfg, B):
    g = np.random.default_rng(7)
    return torch.as_tensor(g.integers(0, cfg.vocab, (B, SEQ.get(arch, S))),
                           dtype=torch.long)


def _spawn(target, *args, world=2):
    """``world`` ranks running ``target(rank, port, *args, q)``; returns
    (processes, queue)."""
    from repro_torch.launch.mesh import _free_port
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=target, args=(r, port, *args, q))
             for r in range(world)]
    for p in procs:
        p.start()
    return procs, q


def _collect(procs, q):
    """Rank 0's items until its end mark, or until every rank has ended
    without one; every rank joined."""
    runs, deadline = {}, time.monotonic() + 600
    try:
        while time.monotonic() < deadline:
            try:
                item = q.get(timeout=5)
            except queue.Empty:
                if all(p.exitcode is not None for p in procs):
                    break
                continue
            if item is None:
                break
            runs[item[0]] = item[1]
    finally:
        for p in procs:
            p.join(timeout=60)
            if p.is_alive():
                p.kill()
    assert all(p.exitcode == 0 for p in procs), [p.exitcode for p in procs]
    return runs


def _worker(rank, port, npps, q):
    torch.set_num_threads(1)
    import torch.distributed as dist
    from repro_torch.launch.mesh import init_ranks, share_card_gathers
    from repro_torch.launch.train import make_launch_mesh
    os.environ.update(RANK=str(rank), WORLD_SIZE="2",
                      MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    init_ranks("cpu")
    try:
        for arch, shape, B, fsdp in RUNS:
            cfg = _configs(arch)[1]
            lm = M.from_reference(npps[arch], cfg, device="cpu")
            got = chip_smoke.serve_on_mesh(
                cfg, lm, _prompt(arch, cfg, B), DECODE, F32,
                make_launch_mesh("cpu", shape), fsdp=fsdp)
            if rank == 0:
                q.put(((arch, shape, fsdp), got[:3]))
        share_card_gathers("cpu")
        for arch in ROUTED:
            cfg = _configs(arch)[1]
            lm = M.from_reference(npps[arch], cfg, device="cpu")
            for shape, B in JOBS:
                got = chip_smoke.serve_on_mesh(
                    cfg, lm, _prompt(arch, cfg, B), DECODE, F32,
                    make_launch_mesh("cpu", shape))
                if rank == 0:
                    q.put(((arch, shape, "routed"), got[:3]))
    finally:
        dist.destroy_process_group()
        if rank == 0:
            q.put(None)


def _jax_serve(arch, npp, B, toks):
    """JAX's prefill of the prompt and a decode step for each of ``toks``
    (the port's greedy tokens, so that both packages see the same
    inputs); the logits of each call."""
    jcfg, cfg = _configs(arch)
    jp = jax.tree.map(jnp.asarray, npp)
    prompt = _prompt(arch, cfg, B).numpy()
    s = prompt.shape[1]
    caches = JM.make_caches(jcfg, B, s + DECODE, jnp.float32)
    logits, caches = JM.prefill(jp, jcfg, {"tokens": jnp.asarray(
        prompt, jnp.int32)}, caches, dtype=jnp.float32)
    out = [np.asarray(logits)]
    for t, tok in enumerate(toks):
        logits, caches = JM.decode_step(jp, jcfg, caches, jnp.asarray(
            tok, jnp.int32), jnp.int32(s + t), dtype=jnp.float32)
        out.append(np.asarray(logits))
    return out


def _close(got, want, what):
    """Equal op for op; bytes equal to the byte (both are sums of the same
    integers times the same ring factors)."""
    assert set(got) == set(want), (what, got, want)
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=1e-12, abs=0), (
            what, k, got, want)


def _hold_tokens(toks, jax_logits, what):
    """Each greedy token is JAX's argmax of the call before it, except
    where JAX's top two logits there lie within 1e-4."""
    for i, tok in enumerate(toks):
        last = jax_logits[i][:, -1]
        top2 = np.sort(last, axis=-1)[:, -2:]
        clear = top2[:, 1] - top2[:, 0] > 1e-4
        np.testing.assert_array_equal(tok[clear, 0],
                                      last.argmax(-1)[clear],
                                      err_msg=f"{what} token {i}")


def test_mesh_serving_matches_one_device_and_its_plan():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        npps = {a: _weights(a) for a in ARCHS + list(HEADS)}
        procs, q = _spawn(_worker, npps)
        try:
            one, plans, jx = {}, {}, {}
            for arch in ARCHS + list(HEADS):
                cfg = _configs(arch)[1]
                lm = M.from_reference(npps[arch], cfg, device="cpu")
                for shape, B in JOBS[:1] if arch in HEADS else JOBS:
                    one[(arch, B)] = chip_smoke.serve_on_mesh(
                        cfg, lm, _prompt(arch, cfg, B), DECODE, F32)
                    jx[(arch, B)] = _jax_serve(arch, npps[arch], B,
                                               one[(arch, B)][1])
                    for fsdp in (False, True) if arch in FSDP else (False,):
                        plans[(arch, shape, fsdp)] = chip_smoke.plan_serve(
                            cfg, shape, B, SEQ.get(arch, S), DECODE, F32,
                            fsdp=fsdp,
                            device="cpu")
        finally:
            runs = _collect(procs, q)
    finally:
        torch.set_num_threads(threads)
    for arch, shape, B, fsdp in RUNS:
        logits, toks, tallies = runs[(arch, shape, fsdp)]
        ref_logits, ref_toks = one[(arch, B)][:2]
        what = f"{arch} mesh {shape} batch {B} fsdp {fsdp}"
        for i, (a, b, j) in enumerate(zip(logits, ref_logits, jx[(arch, B)])):
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-4,
                                       err_msg=f"{what} call {i}")
            np.testing.assert_allclose(a, j, rtol=0, atol=1e-4,
                                       err_msg=f"{what} call {i} against "
                                       f"JAX")
        for a, b in zip(toks, ref_toks):
            np.testing.assert_array_equal(a, b, err_msg=what)
        _hold_tokens(toks, jx[(arch, B)], what)
        (pb, pc), (db, dc) = plans[(arch, shape, fsdp)]
        _close(tallies[0]["bytes"], pb, f"{what} prefill bytes")
        assert tallies[0]["counts"] == pc, (what, tallies[0], pc)
        for t in tallies[1:]:
            _close(t["bytes"], db, f"{what} decode bytes")
            assert t["counts"] == dc, (what, t, dc)
        if arch in ROUTED and not fsdp:
            r_logits, r_toks, r_tallies = runs[(arch, shape, "routed")]
            for a, b in zip(r_logits, logits):
                np.testing.assert_array_equal(a, b, err_msg=what)
            for a, b in zip(r_toks, toks):
                np.testing.assert_array_equal(a, b, err_msg=what)
            assert r_tallies == tallies, what


def _worker4(rank, port, npps, q):
    torch.set_num_threads(1)
    import torch.distributed as dist
    from repro_torch.launch.mesh import init_ranks
    from repro_torch.launch.train import make_launch_mesh
    os.environ.update(RANK=str(rank), WORLD_SIZE="4",
                      MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    init_ranks("cpu")
    try:
        for arch in FOUR:
            cfg = _configs(arch)[1]
            lm = M.from_reference(npps[arch], cfg, device="cpu")
            got = chip_smoke.serve_on_mesh(
                cfg, lm, _prompt(arch, cfg, 4), DECODE, F32,
                make_launch_mesh("cpu", (1, 4)))
            if rank == 0:
                q.put((arch, got[:3]))
    finally:
        dist.destroy_process_group()
        if rank == 0:
            q.put(None)


def test_four_ranks_split_query_heads_against_their_key_head():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        npps = {a: _weights(a) for a in FOUR}
        procs, q = _spawn(_worker4, npps, world=4)
        try:
            one, jx, plans, att = {}, {}, {}, {}
            for arch in FOUR:
                cfg = _configs(arch)[1]
                lm = M.from_reference(npps[arch], cfg, device="cpu")
                one[arch] = chip_smoke.serve_on_mesh(
                    cfg, lm, _prompt(arch, cfg, 4), DECODE, F32)
                jx[arch] = _jax_serve(arch, npps[arch], 4, one[arch][1])
                plans[arch] = chip_smoke.plan_serve(
                    cfg, (1, 4), 4, SEQ[arch], DECODE, F32, device="cpu")
                att[arch] = [chip_smoke.plan_attention_flops(
                    cfg, m, 4, SEQ[arch], DECODE, F32)
                    for m in ((1, 4), (1, 1))]
        finally:
            runs = _collect(procs, q)
    finally:
        torch.set_num_threads(threads)
    for arch in FOUR:
        logits, toks, tallies = runs[arch]
        what = f"{arch} mesh (1, 4) batch 4"
        for i, (a, b, j) in enumerate(zip(logits, one[arch][0], jx[arch])):
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-4,
                                       err_msg=f"{what} call {i}")
            np.testing.assert_allclose(a, j, rtol=0, atol=1e-4,
                                       err_msg=f"{what} call {i} against "
                                       f"JAX")
        for a, b in zip(toks, one[arch][1]):
            np.testing.assert_array_equal(a, b, err_msg=what)
        _hold_tokens(toks, jx[arch], what)
        (pb, pc), (db, dc) = plans[arch]
        _close(tallies[0]["bytes"], pb, f"{what} prefill bytes")
        assert tallies[0]["counts"] == pc, (what, tallies[0], pc)
        for t in tallies[1:]:
            _close(t["bytes"], db, f"{what} decode bytes")
            assert t["counts"] == dc, (what, t, dc)
        mine, whole = att[arch]
        assert mine == pytest.approx(whole / 4, rel=1e-12), (what, att)


# -- FSDP training -----------------------------------------------------------

def _tc():
    return TT.TrainConfig(dtype=F32, microbatches=1, warmup=2, steps=10)


def _batches(cfg):
    dc = tpipe.DataConfig(seq_len=TRAIN_S, global_batch=TRAIN_B, seed=3)
    it = tpipe.synthetic_stream(cfg, dc)
    return [next(it) for _ in range(STEPS)]


def _train(arch, npp, mesh=None, fsdp=True):
    """``STEPS`` train steps from JAX's weights, on one device or on
    ``mesh`` (with FSDP's placement where ``fsdp``); each step's metrics,
    weights and first moments in the JAX package's layout, and on the
    mesh the number of weights split over its first and its second
    axis."""
    from repro_torch.launch.train import place
    cfg = _configs(arch)[1]
    lm = M.from_reference(npp, cfg, device="cpu")
    opt = TA.adamw_init(lm)
    out = {"metrics": [], "weights": [], "mu": []}
    if mesh is not None:
        lm, opt = place(lm, opt, mesh, fsdp=fsdp)
        out["split"] = [sum(w.placements[i].is_shard()
                            for w in TA.leaves(lm)) for i in (0, 1)]
    step = TT.make_train_step(cfg, _tc(), mesh)
    for b in _batches(cfg):
        lm, opt, met = step(lm, opt, b)
        out["metrics"].append({k: float(TT.host_value(v))
                               for k, v in met.items()})
        out["weights"].append(M.to_reference(lm, cfg))
        out["mu"].append(M.to_reference(opt["mu"], cfg))
    return out


def _train_worker(rank, port, npps, q):
    torch.set_num_threads(1)
    import torch.distributed as dist
    from repro_torch.launch.mesh import init_ranks
    from repro_torch.launch.train import make_launch_mesh
    os.environ.update(RANK=str(rank), WORLD_SIZE="2",
                      MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    init_ranks("cpu")
    try:
        for arch, shape, fsdp in TRAIN_RUNS:
            out = _train(arch, npps[arch], make_launch_mesh("cpu", shape),
                         fsdp)
            if rank == 0:
                q.put((arch, out))
    finally:
        dist.destroy_process_group()
        if rank == 0:
            q.put(None)


def test_fsdp_training_matches_one_device():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        npps = {a: _weights(a) for a, _, _ in TRAIN_RUNS}
        procs, q = _spawn(_train_worker, npps)
        try:
            one = {a: _train(a, npps[a]) for a, _, _ in TRAIN_RUNS}
        finally:
            runs = _collect(procs, q)
    finally:
        torch.set_num_threads(threads)
    for arch, shape, fsdp in TRAIN_RUNS:
        got, want = runs[arch], one[arch]
        lr = TA.AdamWConfig().lr * want["metrics"][0]["lr_scale"]
        # FSDP split some weights over "data"; tensor parallelism some
        # over "model"
        assert got["split"][0 if fsdp else 1] > 0, arch
        for s in range(STEPS):
            first = s == 0
            for k in ("loss", "grad_norm", "lr_scale") + (
                    ("acc",) if first else ()):
                np.testing.assert_allclose(
                    got["metrics"][s][k], want["metrics"][s][k], rtol=1e-5,
                    err_msg=f"{arch} step {s} {k}")
        m = want["metrics"][0]
        clip = min(1.0, 1.0 / (m["grad_norm"] + 1e-9))
        for a, b, mu, wmu in zip(*(jax.tree.leaves(t) for t in (
                got["weights"][0], want["weights"][0], got["mu"][0],
                want["mu"][0]))):
            np.testing.assert_allclose(
                mu, wmu, rtol=0, atol=1e-5 * max(float(np.abs(wmu).max()),
                                                 0.1 * clip), err_msg=arch)
            tiny = np.abs(wmu) < 0.1 * 100 * TA.AdamWConfig().eps
            np.testing.assert_allclose(a[~tiny], b[~tiny], rtol=1e-4,
                                       atol=1e-5, err_msg=arch)
            assert np.abs(a - b)[tiny].max(initial=0) <= 2 * lr, arch
