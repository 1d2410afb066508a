"""The port's analysis tooling against the JAX package's, on the CPU.

* ``repro_torch.analysis.autotune``: ``bucket`` and the bucket part of
  ``cache_key`` equal ``repro.analysis.autotune``'s over a grid of shapes
  (floors included); ``lookup_plan`` returns ``None`` (the kernel's own
  plan) on every kind of miss and the entry on a hit, read from a
  temporary cache file;
* ``repro_torch.analysis.plan_cost`` over ``PlanMode``: the products'
  FLOPs equal ``repro.analysis.hlo_cost.analyze_hlo``'s on the programs of
  ``tests/test_roofline.py``, the fused bytes of an elementwise chain
  equal its ``bytes``, the ring factors equal JAX's, and traced
  collectives over a fake group of 8 give JAX's wire bytes with a
  ``repro_torch`` call site;
* ``repro_torch.analysis.bounds``: the bounds of the kernel table's
  shape-only rows at the main paths' shapes, the kernels' operators'
  FLOPs against the work functions, and each data-dependent work
  function against its count spelled out on small inputs.
"""

import json
import os
import re
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from repro.analysis import autotune as JT  # noqa: E402
from repro.analysis import hlo_cost as JH  # noqa: E402
from repro.analysis import roofline as JR  # noqa: E402

from repro_torch import kernels  # noqa: E402
from repro_torch.analysis import autotune as TT  # noqa: E402
from repro_torch.analysis import bounds  # noqa: E402
from repro_torch.analysis import plan_cost  # noqa: E402
from repro_torch.analysis import roofline as TR  # noqa: E402
from repro_torch.launch import dryrun as TD  # noqa: E402
from repro_torch.launch.mesh import _mesh  # noqa: E402

CARD = "NVIDIA H100 80GB HBM3"


# ---------------------------------------------------------------------------
# autotune: buckets and lookup
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("B", [0, 1, 2, 3, 5, 64, 100, 1152, 3072, 6144])
def test_bucket_and_key_equal_jax(B):
    """Next power of two per axis with the floors B >= 1, N >= 8, d >= 2,
    and the key's bucket part, as JAX's."""
    for N in (0, 1, 7, 8, 9, 108, 208, 1000, 1008, 4097):
        for d in (0, 1, 2, 3, 16, 17, 64):
            assert TT.bucket(B, N, d) == JT.bucket(B, N, d)
            want = JT.cache_key("kind", B, N, d).split("|", 1)[1]
            got = TT.cache_key(CARD, "pegasos_stage", B, N, d)
            assert got == f"{CARD}|pegasos_stage|{want}"
    assert TT.cache_key(CARD, "threshold_ranges", B, 392, 2, 1000) \
        .endswith(f"_m1024")


def _write(path, payload):
    path.write_text(payload if isinstance(payload, str)
                    else json.dumps(payload))
    return str(path)


def test_lookup_misses_are_none(tmp_path):
    """An absent file, a malformed file, a malformed entry, an unknown card
    and an entry invalid at the exact shape all give ``None``; a valid
    entry is returned."""
    key = TT.cache_key(CARD, "pegasos_stage", 1152, 1008, 2)
    assert TT.lookup_plan("pegasos_stage", CARD, 1152, 1008, 2,
                          path=str(tmp_path / "absent.json")) is None
    for bad in ("{not json", "[1, 2]", json.dumps({"entries": [1]}),
                json.dumps({"entries": {key: "warps 2"}}),
                json.dumps({"entries": {key: {"plan": {"warps": "2"}}}}),
                json.dumps({"entries": {key: {"plan": {"warps": 3}}}}),
                json.dumps({"entries": {key: {"plan": {"warps": 2,
                                                       "team": 1}}}}),
                json.dumps({"entries": {key: {"us": 1.0}}})):
        path = _write(tmp_path / f"bad{abs(hash(bad))}.json", bad)
        assert TT.lookup_plan("pegasos_stage", CARD, 1152, 1008, 2,
                              path=path) is None, bad
    good = _write(tmp_path / "good.json",
                  {"format": 1, "entries": {key: {"plan": {"warps": 2}}}})
    assert TT.lookup_plan("pegasos_stage", CARD, 1152, 1008, 2,
                          path=good) == {"warps": 2}
    # the same bucket at another exact shape; another card; another bucket
    assert TT.lookup_plan("pegasos_stage", CARD, 1025, 513, 2,
                          path=good) == {"warps": 2}
    assert TT.lookup_plan("pegasos_stage", "NVIDIA A100", 1152, 1008, 2,
                          path=good) is None
    assert TT.lookup_plan("pegasos_stage", CARD, 64, 1008, 2,
                          path=good) is None
    assert TT.lookup_plan("median_extremes", CARD, 1152, 1008, 2,
                          path=good) is None


def test_lookup_rejects_plans_the_kernel_cannot_launch(tmp_path):
    """Validity at the exact shape: the stage's shared memory above d=16,
    the ranges scan's per_block > 1 only for transcripts within one chunk
    and per_thread 4 only at d = 2 and 3."""
    entries = {
        TT.cache_key(CARD, "pegasos_stage", 8, 64, 4096):
            {"plan": {"warps": 8}},
        TT.cache_key(CARD, "threshold_ranges", 3072, 392, 2, 1024):
            {"plan": {"per_thread": 4, "per_block": 3}},
        TT.cache_key(CARD, "threshold_ranges", 24, 2000, 2, 1024):
            {"plan": {"per_thread": 4, "per_block": 2}},
        TT.cache_key(CARD, "threshold_ranges", 24, 100, 16, 1024):
            {"plan": {"per_thread": 4, "per_block": 1}},
        TT.cache_key(CARD, "maxmarg_turn_scan", 3456, 1008, 2):
            {"plan": {"team": 16}},
    }
    path = _write(tmp_path / "c.json", {"format": 1, "entries": entries})
    # 8 warps x 2 x 4096 floats is 256 KB of shared memory: too much
    assert TT.lookup_plan("pegasos_stage", CARD, 8, 64, 4096,
                          path=path) is None
    assert TT.valid_plan("pegasos_stage", {"warps": 4}, 8, 64, 4096) \
        == {"warps": 4}
    assert TT.lookup_plan("threshold_ranges", CARD, 3072, 392, 2, 1024,
                          path=path) == {"per_thread": 4, "per_block": 3}
    # 2000 rows take two chunks: one instance a block
    assert TT.lookup_plan("threshold_ranges", CARD, 24, 2000, 2, 1024,
                          path=path) is None
    assert TT.lookup_plan("threshold_ranges", CARD, 24, 100, 16, 1024,
                          path=path) is None
    assert TT.lookup_plan("maxmarg_turn_scan", CARD, 3456, 1008, 2,
                          path=path) is None
    # every candidate the search would time is valid, own plans included
    for kernel, _, s in TT.MAIN_PATH:
        shape = TT.plan_shape(kernel, s)
        cands = TT.candidates(kernel, *shape)
        assert cands and all(TT.valid_plan(kernel, p, *shape) == p
                             for p in cands)


def test_committed_cache_is_valid_and_names_its_card(monkeypatch):
    """Every committed entry names the card and its power limit, keys the
    shape it was tuned at, is a plan the kernel launches there, and is
    what a wrapper on that card gets (``plan_for``)."""
    import torch
    with open(TT.CACHE_PATH) as fh:
        entries = json.load(fh)["entries"]
    assert entries
    monkeypatch.setattr(TT, "_device_name", lambda index: CARD)
    TT._plan_at.cache_clear()
    try:
        for key, e in entries.items():
            name, kernel, _ = key.split("|")
            assert name == CARD and e["card"].startswith(f"{CARD}, ")
            assert e["card"].endswith(" W")
            assert TT.cache_key(name, kernel, *e["shape"]) == key
            assert TT.valid_plan(kernel, e["plan"], *e["shape"]) == e["plan"]
            # recorded only where it beat the own plan by more than the
            # own plan's spread between rounds and by MIN_GAIN
            assert e["plan"] != e["own_plan"] and e["bound_us"] > 0
            assert 0 < e["us"] < e["own_us"] - e["own_spread_us"]
            assert e["us"] < (1 - TT.MIN_GAIN) * e["own_us"]
            assert TT.plan_for(kernel, torch.device("cuda", 0),
                               *e["shape"]) == e["plan"]
    finally:
        TT._plan_at.cache_clear()


def test_search_needs_a_card(monkeypatch):
    """The search half times kernels on the card: without one it raises
    rather than tune anything."""
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA card"):
        TT.main(["--shapes", "SOU state"])


def test_ranges_plan_split_keeps_the_fold_order():
    """A tuned ranges plan changes directions a thread and instances a
    block only; warps a row group and the chunk stay the own split's."""
    sm = kernels.support_margin
    own = sm.ranges_occupancy(3072, 1024, 392, 2, sms=132, per_sm=4)
    got = sm.ranges_plan_split(own, {"per_thread": 1, "per_block": 2}, 1024)
    assert (got.warps, got.chunk) == (own.warps, own.chunk)
    assert (got.per_thread, got.per_block) == (1, 2)
    assert got.tiles == -(-1024 // (32 * own.warps))
    assert sm.ranges_plan_split(own, None, 1024) == own


def _cu_ints(name):
    """``constexpr int`` constants of a CUDA source of the port."""
    path = os.path.join(os.path.dirname(kernels.__file__), "csrc", name)
    with open(path) as fh:
        text = fh.read()
    return text, {k: int(v) for k, v in re.findall(
        r"constexpr int (k\w+) = (\d+);", text)}


def test_kernel_limits_match_their_sources():
    """The launch limits that the wrappers' plan checks hold (and the
    tuner reads through them) are the CUDA sources' own."""
    pg, sm = kernels.pegasos, kernels.support_margin
    text, c = _cu_ints("pegasos_stage.cu")
    assert (c["kThreads"], c["kSmallD"]) == (pg.THREADS, pg.SMALL_D)
    assert max(pg.WARPS) == c["kMaxWarps"] and c["kWarps"] in pg.WARPS
    assert "warps != 1 && warps != 2 && warps != 4 && warps != kMaxWarps" \
        in text
    text, c = _cu_ints("threshold_ranges.cu")
    assert (c["kMaxBatch"], c["kThreads"]) == (sm._RANGES_MAX_BATCH,
                                               sm._RANGES_THREADS)
    assert "d > 0 && d <= 64" in text
    assert "(per_thread == 1 || ((d == 2 || d == 3) && per_thread == 4))" \
        in text
    assert "(per_block > 1 && n > chunk)" in text
    for name, var in (("median_extremes.cu", "team"),
                      ("maxmarg_turn.cu", "team_req")):
        text, _ = _cu_ints(name)
        allowed = " && ".join(f"{var} != {t}" for t in sm.TEAMS)
        assert allowed in text, name


# ---------------------------------------------------------------------------
# plan_cost against hlo_cost
# ---------------------------------------------------------------------------

def _jax_cost(fn, *shapes):
    args = [jax.ShapeDtypeStruct(s, jnp.float32) for s in shapes]
    return JH.analyze_hlo(jax.jit(fn).lower(*args).compile().as_text())


def _planned(fn, *shapes):
    mode = TR.PlanMode()
    with mode:
        args = [torch.empty(s) for s in shapes]
        mode.start()
        fn(*args)
    return mode


def _chain(x, n):
    for _ in range(n):
        x = x @ x
    return x


def _jax_scan(n):
    def f(x):
        out, _ = jax.lax.scan(lambda c, _: (c @ c, None), x, None, length=n)
        return out
    return f


def _jax_nested(x):
    def outer(c, _):
        c2, _ = jax.lax.scan(lambda ci, _: (ci @ ci, None), c, None,
                             length=3)
        return c2, None
    out, _ = jax.lax.scan(outer, x, None, length=4)
    return out


@pytest.mark.parametrize("case", ["single", "scan10", "nested4x3",
                                  "batched"])
def test_dot_flops_equal_hlo_cost(case):
    """The products' FLOPs of the port's trace equal ``analyze_hlo``'s of
    JAX's compiled program to 1e-2: a Python loop stands for each
    ``lax.scan``."""
    if case == "single":
        want = _jax_cost(lambda a, b: a @ b, (64, 128), (128, 32))
        mode = _planned(lambda a, b: a @ b, (64, 128), (128, 32))
    elif case == "scan10":
        want = _jax_cost(_jax_scan(10), (128, 128))
        mode = _planned(lambda x: _chain(x, 10), (128, 128))
    elif case == "nested4x3":
        want = _jax_cost(_jax_nested, (64, 64))
        mode = _planned(lambda x: [_chain(x, 3) for _ in range(4)],
                        (64, 64))
    else:
        want = _jax_cost(lambda a, b: jnp.einsum("bij,bjk->bik", a, b),
                         (8, 32, 64), (8, 64, 16))
        mode = _planned(lambda a, b: torch.einsum("bij,bjk->bik", a, b),
                        (8, 32, 64), (8, 64, 16))
    got = plan_cost.dot_flops(mode.flops_by_op)
    assert got == pytest.approx(want["flops"], rel=1e-2)
    rep = TR.analyze_plan("t", mode, chips=1, arg_bytes=0)
    assert rep.dot_flops == got and rep.flops >= got


def test_fused_bytes_of_an_elementwise_chain():
    """``a * 2.0 + 1.0`` over 1024² f32: the intermediate is neither
    written nor read, 2·4 MiB in all, ``analyze_hlo``'s bytes to 1%; the
    unfused count stays 4·4 MiB."""
    mib4 = 1024 * 1024 * 4
    mode = _planned(lambda a: a * 2.0 + 1.0, (1024, 1024))
    assert mode.bytes == 4 * mib4
    assert mode.bytes_fused == 2 * mib4
    want = _jax_cost(lambda a: a * 2.0 + 1.0, (1024, 1024))
    assert mode.bytes_fused == pytest.approx(want["bytes"], rel=1e-2)
    rep = TR.analyze_plan("t", mode, chips=1, arg_bytes=0)
    assert rep.bytes_accessed == 4 * mib4 and rep.bytes_fused == 2 * mib4
    assert rep.memory_fused_s == pytest.approx(2 * mib4 / bounds.HBM_BW)


def test_fused_bytes_keep_what_a_compiler_must_move():
    """An intermediate read twice, or read by a product, is written and
    read as before; in place updates chain like new values; views are
    free."""
    mib = 256 * 256 * 4
    # t read by two pointwise ops: counted in full (sin's output, read
    # once by the add, is not)
    mode = _planned(lambda a: (lambda t: t + t.sin())(a * 2.0), (256, 256))
    assert mode.bytes == 7 * mib and mode.bytes_fused == 5 * mib
    # t read by a product: counted in full
    mode = _planned(lambda a: (a * 2.0) @ a, (256, 256))
    assert mode.bytes_fused == mode.bytes
    # a pointwise chain through a view and an in-place update
    mode = _planned(lambda a: (a * 2.0).reshape(-1).add_(1.0).exp(),
                    (256, 256))
    assert mode.bytes >= 6 * mib and mode.bytes_fused == 2 * mib


def test_ring_factors_equal_jax():
    for op in ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute"):
        for g in (1, 2, 8, 256):
            assert plan_cost.ring_factor(op, g) == JH._ring_factor(op, g)
            assert plan_cost.ring_factor(op, g) == JR._ring_factor(op, g)


def test_top_collectives_wire_bytes_and_sites():
    """An all-gather, an all-reduce and a reduce-scatter issued by
    ``constraints.constrain`` over a fake group of 8: JAX's wire bytes
    (output payload × ring factor), counted once each, with the
    ``repro_torch`` frame that issued them."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    from repro_torch.distribution import constraints

    TD.fake_group(8)
    try:
        mesh = _mesh("cpu", (8, 1), ("data", "model"))
        mode = TR.PlanMode()
        with mode:
            shard = DTensor.from_local(torch.empty(16, 32), mesh,
                                       [Shard(0), Replicate()],
                                       run_check=False)
            part = DTensor.from_local(torch.empty(128, 32), mesh,
                                      [Partial(), Replicate()],
                                      run_check=False)
            mode.start()
            with constraints.use_mesh(mesh):
                constraints.constrain(shard, None)
                constraints.constrain(part, None)
                constraints.constrain(part, "data")
        rep = TR.analyze_plan("t", mode, chips=8, arg_bytes=0)
    finally:
        dist.destroy_process_group()
    full, local = 128 * 32 * 4, 16 * 32 * 4
    want = {"all-gather": full * JH._ring_factor("all-gather", 8),
            "all-reduce": full * JH._ring_factor("all-reduce", 8),
            "reduce-scatter": local * JH._ring_factor("reduce-scatter", 8)}
    rows = [r for r in plan_cost.top_collectives(mode) if r["group"] == 8]
    assert {r["op"]: r["bytes"] for r in rows} == {
        k: int(v) for k, v in want.items()}
    assert all(r["count"] == 1 for r in rows)
    assert rows[0]["op"] == "all-reduce"          # the most wire bytes
    assert all(r["site"].startswith(
        "repro_torch.distribution.constraints:") for r in rows)
    assert rep.top_collectives == plan_cost.top_collectives(mode)
    assert rep.collective_bytes == pytest.approx(sum(want.values()))


# ---------------------------------------------------------------------------
# bounds
# ---------------------------------------------------------------------------

def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


def test_card_figures_have_one_definition():
    from repro_torch.launch import mesh
    assert (bounds.PEAK_F32, bounds.PEAK_FLOPS_BF16, bounds.HBM_BW,
            bounds.NVLINK_BW, bounds.CHIP_HBM_BYTES) == (
        67e12, 989e12, 3.35e12, 450e9, 80e9)
    assert bounds.PEAK_SFU == 132 * 16 * 1.98e9 and bounds.POLY_EXP_OPS == 14
    assert mesh.PEAK_FLOPS_BF16 is bounds.PEAK_FLOPS_BF16
    assert TR.HBM_BW is bounds.HBM_BW


def test_shape_only_rows_equal_the_kernel_table():
    """Rows 9-11 of PERF.md's kernel table at the main paths' shapes, to
    four significant digits: ``tc`` at smollm-135m scoring (B=8 S=2048,
    bf16) 0.03910 ms, WKV at rwkv6-7b scoring (bf16 r, k, v, f32 w, u)
    0.3255 ms, the selective scan at Jamba scoring (bf16) 0.6864 ms with
    its exponentials split."""
    bf16 = torch.bfloat16
    q, kv = _meta(8, 2048, 9, 64, dtype=bf16), _meta(8, 2048, 3, 64,
                                                     dtype=bf16)
    ms, by = bounds.bound_ms(bounds.attention_work(q, kv, kv, True),
                             bounds.PEAK_FLOPS_BF16)
    assert (f"{ms:.4g}", by) == ("0.0391", "operations")
    r = _meta(8, 2048, 64, 64, dtype=bf16)
    work = bounds.wkv_work(r, r, r, _meta(8, 2048, 64, 64), _meta(64, 64))
    assert work.bytes == 947929088
    assert (f"{bounds.bound_ms(work)[0]:.4g}", bounds.bound_ms(work)[1]) \
        == ("0.3255", "operations")
    xc = _meta(8, 2048, 16384, dtype=bf16)
    bc = _meta(8, 2048, 16, dtype=bf16)
    work = bounds.scan_work(xc, xc, _meta(16384, 16), bc, bc)
    assert work.bytes == 1621098496
    assert (f"{bounds.bound_ms(work)[0]:.4g}", bounds.bound_ms(work)[1]) \
        == ("0.6864", "operations")
    assert f"{work.exps / bounds.PEAK_SFU * 1e3:.4g}" == "1.027"


def test_kernel_operators_count_what_bounds_count():
    """The FLOPs of the kernels' operators (``kernels._ops``) under the
    planner are the work functions' operations."""
    B, S, H, hd, di, ds = 2, 70, 3, 32, 48, 16
    mode = TR.PlanMode()
    with mode:
        mode.start()
        r = torch.empty(B, S, H, hd)
        kernels.rwkv6(r, r, r, r, torch.empty(H, hd))
        x = torch.empty(B, S, di)
        kernels.mamba_scan(x, x, torch.empty(di, ds), torch.empty(B, S, ds),
                           torch.empty(B, S, ds))
        q = torch.empty(B, S, 4, 64)
        kv = torch.empty(B, 50, 2, 64)
        kernels.attention(q, kv, kv, causal=True, window=16)
    got = mode.flops_by_op
    assert got["rwkv6"] == bounds.wkv_ops(B, S, H, hd)
    assert got["mamba_scan"] == bounds.scan_ops(B, S, di, ds).ops
    assert got["attention"] == bounds.attention_ops((B, S, 4, 64), 50, True,
                                                    16)
    assert bounds.attention_work(q, kv, kv, True, 16).ops == got["attention"]


def _labels(rng, *shape):
    y = rng.choice([-1, 0, 1], size=shape).astype(np.int32)
    return torch.from_numpy(y)


def test_protocol_work_functions_count_their_inputs():
    """Rows 1-6's work on small inputs, spelled out: inputs read once,
    outputs written once, operations per live row."""
    rng = np.random.default_rng(0)
    B, k, n, m, W, cap, d = 3, 2, 7, 5, 3, 6, 2

    def pts(*shape):
        return torch.from_numpy(rng.standard_normal(shape)
                                .astype(np.float32))

    V, X, y = pts(m, 2), pts(B, n, 2), _labels(rng, B, n)
    ok = torch.from_numpy(rng.random((B, m)) < 0.7)
    lo, hi = pts(B, m), pts(B, m)
    live = int((y != 0).sum())
    w = bounds.cut_work(V, ok, lo, hi, X, y)
    assert w == (8 * m + 13 * B * m + 12 * B * n, 3 * live * m, 0)
    assert bounds.cut_work(V, ok, lo, hi, X, y, live=5).ops == 15 * m

    v, Xk, yk = pts(B, 2), pts(B, k, n, 2), _labels(rng, B, k, n)
    wx, wy = pts(B, k, cap, 2), _labels(rng, B, k, cap)
    rows = int((yk != 0).sum()) + int((wy[:, :, :W] != 0).sum())
    w = bounds.extremes_work(v, Xk, yk, wx, wy, W)
    assert w == (8 * B + 12 * B * k * (n + W) + 34 * B * k, 3 * rows, 0)
    assert bounds.extremes_work(v, Xk, yk).bytes \
        == 8 * B + 12 * B * k * n + 8 * B * k

    N = 9
    wv, bv, K, yK = pts(B, d), pts(B), pts(B, N, d), _labels(rng, B, N)
    w = bounds.turn_work(wv, bv, K, yK, Xk, yk, max_support=4, viol_ship=2)
    assert w.bytes == (4 * B * (d + 1) + 12 * B * N + 12 * B * k * n
                       + 4 * (B * N + B * k + B * k * n))
    assert w.ops == ((2 * d + 2 + 4) * int((yK != 0).sum())
                     + (2 * d + 2 + 2) * int((yk != 0).sum()))

    yf = yK.float()
    f32 = torch.zeros(B)
    w = bounds.pegasos_work(K, yf, f32, wv, f32, f32,
                            torch.zeros(B, dtype=torch.bool), wv, f32,
                            nsteps=10)
    assert w.bytes == (4 * B * N * d + 4 * B * N + 4 * B * 4 + B
                       + 8 * B * d + 4 * (3 * B * d + 3 * B) + B)
    assert w.ops == 11 * int((yK != 0).sum()) * (2 * d + 2)

    Xw, yw = pts(B, n, d), _labels(rng, B, n)
    lv = int((yw != 0).sum())
    assert bounds.ranges_work(V, Xw, yw) == (
        8 * m + 4 * B * n + lv * 8 + 8 * B * m, 2 * d * lv * m, 0)


def test_uncertain_work_counts_tests_up_to_the_first_risk():
    """The SOU scan's tests, against a loop over (instance, point,
    direction)."""
    rng = np.random.default_rng(1)
    B, m, n = 3, 6, 5
    V = torch.from_numpy(rng.standard_normal((m, 2)).astype(np.float32))
    X = torch.from_numpy(rng.standard_normal((B, n, 2)).astype(np.float32))
    y = torch.from_numpy(rng.choice([-1, 1], size=(B, n)).astype(np.int32))
    lo = torch.from_numpy(rng.standard_normal((B, m)).astype(np.float32))
    hi = lo + torch.from_numpy(rng.standard_normal((B, m))
                               .astype(np.float32))
    ok = torch.from_numpy(rng.random((B, m)) < 0.8)
    ok[2] = False                                # no direction: no point read
    proj = (V[None, :, None, :] * X[:, None]).sum(-1).numpy()   # (B, m, n)
    tests = 0
    for b in range(B):
        for j in range(n):
            for i in range(m):
                if not (ok[b, i] and lo[b, i] < hi[b, i]):
                    continue
                tests += 1
                p = proj[b, i, j]
                if (p > lo[b, i]) if y[b, j] == 1 else (p < hi[b, i]):
                    break
    got_tests, rounds = bounds.uncertain_tests(V, ok, lo, hi, X, y)
    assert got_tests == tests and rounds <= B * n
    needed = int(((lo < hi) & ok).any(dim=1).sum())
    assert bounds.uncertain_work(V, ok, lo, hi, X, y) == (
        8 * m + 9 * B * m + needed * n * 12 + B * n, 4 * tests, 0)
