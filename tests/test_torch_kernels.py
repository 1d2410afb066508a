"""The port's kernel modules on the CPU: the plain PyTorch versions against
the JAX package's jnp twins, and the wrappers' routing.

The CUDA kernels themselves run only on the card; ``chip_smoke.py`` holds
them against these plain versions there.  Here every input is in general
position (random normals, bounds drawn apart from the projections), so the
twins' dot-product projections and the port's one-rounding-per-operation
projections make the same decisions.  Tolerances:

* MEDIAN scans and the MAXMARG turn scan: integer-exact (the turn scan's
  crafted ties too: there every margin is an exact copy of a coordinate,
  so a dot and the port's sum agree).  MEDIAN's ties (bounds built from the
  scanned points) are held against JAX's inline path in
  tests/test_torch_median.py.
* The Pegasos stage: ``found`` exact; w, b, mmin, w_best, b_best to
  rtol 1e-5, atol 1e-6 — the tier the JAX package holds its own tiled
  kernel to against the twin (tests/test_kernels_interpret.py), since the
  twin's einsum and the port's ordered block sum add the hinge gradient in
  different orders.  The port's block sum is held bit for bit to a scalar
  replica of the CUDA kernel's reduction order.
"""

import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp

from repro.core import geometry as jgeo
from repro.kernels import ops, ref

import torch

import chip_smoke
from repro_torch import kernels
from repro_torch.core import geometry as tgeo
from repro_torch.kernels import _build, median_cut, pegasos, support_margin


def _cut_inputs(seed, B=5, m=128, n=48):
    rng = np.random.default_rng(seed)
    V = np.array(jgeo.direction_grid(m))
    X = rng.normal(size=(B, n, 2)).astype(np.float32)
    y = rng.choice([-1, 1], size=(B, n)).astype(np.int32)
    y[:, -5:] = 0                                  # padding rows
    c = rng.normal(scale=0.5, size=(B, m)).astype(np.float32)
    w = rng.uniform(-0.5, 1.5, size=(B, m)).astype(np.float32)
    lo, hi = c - w / 2, c + w / 2                  # some bands empty
    lo[:, ::7] = -np.inf                           # no positives seen
    hi[:, ::11] = np.inf                           # no negatives seen
    dir_ok = rng.random((B, m)) < 0.75
    dir_ok[1] = False                              # nothing allowed
    return V, dir_ok, lo, hi, X, y


def _extremes_inputs(seed, B=4, k=3, nW=57):
    rng = np.random.default_rng(seed)
    ang = rng.uniform(0, 2 * np.pi, B)
    v = np.stack([np.cos(ang), np.sin(ang)], -1).astype(np.float32)
    XW = rng.normal(size=(B, k, nW, 2)).astype(np.float32)
    yW = rng.choice([-1, 0, 1], size=(B, k, nW)).astype(np.int32)
    yW[0, 1] = np.where(yW[0, 1] == 1, -1, yW[0, 1])   # a node without +1
    yW[2, 2] = 0                                          # padding only
    return v, XW, yW


def _turn_inputs(seed, B=4, N=50, k=3, n=30, d=3):
    rng = np.random.default_rng(seed)
    w = rng.normal(size=(B, d)).astype(np.float32)
    b = rng.normal(size=B).astype(np.float32)
    K = rng.normal(size=(B, N, d)).astype(np.float32)
    yK = rng.choice([-1, 0, 1], size=(B, N), p=[0.4, 0.2, 0.4])
    X = rng.normal(size=(B, k, n, d)).astype(np.float32)
    y = rng.choice([-1, 0, 1], size=(B, k, n), p=[0.4, 0.2, 0.4])
    return w, b, K, yK.astype(np.int32), X, y.astype(np.int32)


def _stage_inputs(seed, B=4, N=40, d=3):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(B, N, d)).astype(np.float32)
    y = rng.choice([-1.0, 0.0, 1.0], size=(B, N)).astype(np.float32)
    nv = np.maximum((y != 0).sum(axis=1), 1).astype(np.float32)
    w = rng.normal(size=(B, d)).astype(np.float32)
    b = rng.normal(size=B).astype(np.float32)
    lam = np.full(B, 1e-2, np.float32)
    found = rng.random(B) < 0.5
    return (X, y, nv, w, b, lam, found, rng.normal(size=(B, d)).astype(
        np.float32), rng.normal(size=B).astype(np.float32))


def _jax_turn_inputs(B, N, k, n, d):
    """tests/test_kernels.py's turn-scan inputs (jax.random), as numpy."""
    ks = jax.random.split(jax.random.PRNGKey(B * N + n), 8)
    K = jax.random.normal(ks[0], (B, N, d))
    yK = jnp.where(jax.random.bernoulli(ks[1], 0.5, (B, N)), 1, -1)
    yK = yK * jax.random.bernoulli(ks[2], 0.8, (B, N))
    X = jax.random.normal(ks[3], (B, k, n, d))
    y = jnp.where(jax.random.bernoulli(ks[4], 0.5, (B, k, n)), 1, -1)
    y = y * jax.random.bernoulli(ks[5], 0.8, (B, k, n))
    w = jax.random.normal(ks[6], (B, d))
    b = jax.random.normal(ks[7], (B,))
    return tuple(np.array(a, dtype=np.int32 if a.dtype != jnp.float32
                            else np.float32) for a in (w, b, K, yK, X, y))


def _jax_stage_inputs(B, N, d, seed=3, found_frac=0.3):
    """tests/test_kernels_interpret.py's Pegasos-stage inputs, as numpy."""
    ks = jax.random.split(jax.random.PRNGKey(seed), 6)
    X = jax.random.normal(ks[0], (B, N, d), jnp.float32)
    y = jnp.where(jax.random.bernoulli(ks[1], 0.5, (B, N)), 1.0, -1.0)
    y = y * jax.random.bernoulli(ks[2], 0.85, (B, N))
    nv = jnp.maximum(jnp.sum(y != 0, axis=1), 1).astype(jnp.float32)
    found = jax.random.bernoulli(ks[3], found_frac, (B,))
    w_best = jax.random.normal(ks[4], (B, d), jnp.float32)
    b_best = jax.random.normal(ks[5], (B,), jnp.float32)
    return tuple(np.array(a) for a in (
        X, y, nv, jnp.zeros((B, d)), jnp.zeros((B,)),
        jnp.full((B,), 1e-2, jnp.float32), found, w_best, b_best))


def _assert_stage_close(got, want):
    names = ("w", "b", "mmin", "found", "w_best", "b_best")
    for name, g, e in zip(names, got, want):
        if name == "found":
            np.testing.assert_array_equal(g.numpy(), np.asarray(e))
        else:
            np.testing.assert_allclose(g.numpy(), np.asarray(e), rtol=1e-5,
                                       atol=1e-6, err_msg=name)


@pytest.mark.parametrize("B,N,k,n,d", [(1, 64, 2, 48, 2), (5, 33, 3, 21, 2),
                                       (4, 100, 2, 80, 5), (3, 24, 4, 16, 10)])
def test_turn_scan_plain_matches_jnp_twin(B, N, k, n, d):
    """tests/test_kernels.py's grid: label-0 padding rows, one-class fit
    sets; sentinels N and n, as the JAX wrapper restores them."""
    args = _jax_turn_inputs(B, N, k, n, d)
    want = ref.maxmarg_turn_batch_ref(*args)
    got = kernels.maxmarg_turn_scan_plain(*map(torch.from_numpy, args))
    for g, e in zip(got, want):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(e))
    assert int(got[0].max()) <= N and int(got[2].max()) <= n


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_turn_scan_plain_matches_jnp_twin_on_crafted_ties(seed):
    """chip_smoke.py's crafted inputs: a row exactly on the band edge and
    one a step beyond it, equal margins many times over (ties broken by
    index), a node without valid rows, a padding-only instance, a fit set
    the proposal misclassifies (the 1e-12 clamp)."""
    args = chip_smoke.crafted_turn_inputs("cpu", seed)
    want = ref.maxmarg_turn_batch_ref(*(a.numpy() for a in args))
    got = kernels.maxmarg_turn_scan_plain(*args)
    for g, e in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(e))
    sup, err, viol = got
    assert sup[0, :4].tolist() == [0, 1, 64, 2]     # edge in, next out
    assert (sup[3] == 64).all() and (err[3] == 0).all() and (viol[3] == 40).all()
    assert (viol[2, 1] == 40).all() and int(err[2, 1]) == 0
    assert int((sup[4] < 4).sum()) == 4             # ranks by the clamp


@pytest.mark.parametrize("case", ["single_tile", "tiled_grid", "warm_latched"])
def test_stage_plain_matches_jnp_twin(case):
    """The cases of tests/test_kernels_interpret.py (lane-aligned d, an
    unaligned d and N, and the warm offset with every instance latched)."""
    B, N, d, seed, frac, nsteps, t0 = {
        "single_tile": (6, 48, 8, 3, 0.3, 60, 0.0),
        "tiled_grid": (5, 70, 12, 9, 0.3, 60, 0.0),
        "warm_latched": (4, 32, 8, 5, 1.0, 40, 1024.0)}[case]
    args = _jax_stage_inputs(B, N, d, seed, frac)
    want = ref.pegasos_stage_batch_ref(*args, nsteps=nsteps, t0=t0)
    got = kernels.pegasos_stage_plain(*map(torch.from_numpy, args),
                                      nsteps=nsteps, t0=t0)
    _assert_stage_close(got, want)
    if case == "warm_latched":
        np.testing.assert_array_equal(got[4].numpy(), args[7])


@pytest.mark.parametrize("seed", [0, 1])
def test_stage_plain_matches_jnp_twin_on_crafted_inputs(seed):
    """chip_smoke.py's crafted stage: a padding-only instance (min margin
    BIG, latched), one entering latched, duplicate rows, random labels."""
    args = chip_smoke.crafted_pegasos_inputs("cpu", seed)
    want = ref.pegasos_stage_batch_ref(*(a.numpy() for a in args),
                                       nsteps=120)
    got = kernels.pegasos_stage_plain(*args, nsteps=120)
    _assert_stage_close(got, want)
    assert float(got[2][2]) == np.float32(pegasos.BIG) and bool(got[3][2])
    assert bool(got[3][1]) and not bool(got[3][4])


def test_stage_skip_latched_keeps_entry_iterates():
    """With ``skip_latched`` a latched instance leaves the stage at its
    entry (w, b), its latched (w_best, b_best) untouched; the others step
    exactly as without it."""
    args = tuple(map(torch.from_numpy, _stage_inputs(5, B=6)))
    found = args[6]
    assert found.any() and not found.all()
    plain = kernels.pegasos_stage_plain(*args, nsteps=25)
    skip = kernels.pegasos_stage_plain(*args, nsteps=25, skip_latched=True)
    assert torch.equal(skip[0][found], args[3][found])
    assert torch.equal(skip[1][found], args[4][found])
    for a, b in zip(plain, skip):
        assert torch.equal(a[~found], b[~found])
    assert torch.equal(skip[4][found], args[7][found])
    assert skip[3][found].all()


def _kernel_order_sum(c: np.ndarray) -> np.ndarray:
    """Scalar replica of csrc/pegasos_stage.cu's reduction: lane t of the
    instance's warp sums rows t, t+32, ... onto 0.0f; the 32 lanes fold at
    offsets 16, 8, 4, 2, 1 (lane l adding lane l + offset); no cross-warp
    step."""
    f = np.float32
    N, d = c.shape
    out = np.zeros(d, np.float32)
    for i in range(d):
        lanes = [f(0.0)] * 32
        for t in range(32):
            for r in range(t, N, 32):
                lanes[t] = f(lanes[t] + c[r, i])
        off = 16
        while off:
            lanes = [f(lanes[l] + lanes[l + off]) if l + off < 32
                     else lanes[l] for l in range(32)]
            off //= 2
        out[i] = lanes[0]
    return out


@pytest.mark.parametrize("N", [7, 256, 601])
def test_block_sum_is_the_kernels_order(N):
    rng = np.random.default_rng(N)
    c = (rng.normal(size=(2, N, 3)) * 10.0 ** rng.integers(-3, 4, (2, N, 3))
         ).astype(np.float32)
    got = pegasos.block_sum(torch.from_numpy(c)).numpy()
    for b in range(2):
        np.testing.assert_array_equal(got[b], _kernel_order_sum(c[b]))
    cu = (_build.CSRC / "pegasos_stage.cu").read_text()
    assert f"kThreads = {pegasos.THREADS};" in cu


def test_plain_sqrt_is_correctly_rounded():
    """The plain stage's square root equals IEEE f32 sqrt (numpy's), as the
    kernel's ``__fsqrt_rn`` does — also where torch's CPU sqrt is 1 ulp
    off, and next to the midpoints between floats."""
    rng = np.random.default_rng(0)
    x = (rng.random(400_000) * 10.0 ** rng.integers(-30, 30, 400_000)
         ).astype(np.float32)
    k = np.arange(1, 4097, dtype=np.float32)
    x[:4096] = np.nextafter(k * k, np.float32(np.inf))
    x[4096:8192] = np.nextafter(k * k, np.float32(0))
    x[8192:8196] = (0.0, 1.0, np.inf, 2.0 ** -126)
    got = pegasos.sqrt_rn(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, np.sqrt(x))
    assert "__fsqrt_rn" in (_build.CSRC / "pegasos_stage.cu").read_text()


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_cut_plain_matches_jnp_twin(seed):
    args = _cut_inputs(seed)
    want = np.asarray(ref.median_cut_scores_batch_ref(*args))
    got = kernels.median_cut_scores_plain(*map(torch.from_numpy, args))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert (got[1] == -1).all()


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_extremes_plain_matches_jnp_twin(seed):
    args = _extremes_inputs(seed)
    want_p, want_q = ref.median_extremes_batch_ref(*args)
    i_p, i_q = kernels.median_extremes_plain(*map(torch.from_numpy, args))
    assert i_p.dtype == torch.int32 and i_q.dtype == torch.int32
    np.testing.assert_array_equal(i_p.numpy(), np.asarray(want_p))
    np.testing.assert_array_equal(i_q.numpy(), np.asarray(want_q))
    assert int(i_p[0, 1]) == 0 and int(i_q[2, 2]) == 0


def _jax_interpret_extremes(v, XW, yW):
    """The JAX package's Pallas extremes kernel in interpret mode, as
    tests/test_kernels_interpret.py runs it."""
    from jax.experimental.pallas import tpu as pltpu
    import contextlib
    ctx = (pltpu.force_tpu_interpret_mode()
           if hasattr(pltpu, "force_tpu_interpret_mode")
           else contextlib.nullcontext())
    with ctx:
        got = ops.support_extremes_batch(
            *(jnp.asarray(a.numpy()) for a in (v, XW, yW)), interpret=True)
    return tuple(np.asarray(g) for g in got)


@pytest.mark.parametrize("seed,n,width", [(0, 41, 45), (1, 41, 0),
                                          (2, 40, 1), (3, 7, 47),
                                          (4, 64, 33)])
def test_extremes_segments_plain_is_the_scan_of_the_concatenation(
        seed, n, width):
    """Own rows and transcript read as two segments give the one-segment
    scan of their concatenation and the JAX package's Pallas kernel on it:
    ties across the boundary (every transcript starts with a copy of the
    own rows), a class in one segment only, an empty node, W = 0, odd n and
    W; the rows, class flags and band edges are the concatenation's."""
    v, X, y, wx, wy, W = chip_smoke.crafted_segment_inputs(
        "cpu", seed, n=n, width=width)
    e = kernels.median_extremes_segments_plain(v, X, y, wx, wy, W)
    XW = torch.cat([X, wx[:, :, :W]], dim=2)
    yW = torch.cat([y, wy[:, :, :W]], dim=2)
    i_p, i_q = kernels.median_extremes_plain(v, XW, yW)
    assert torch.equal(e.i_p, i_p) and torch.equal(e.i_q, i_q)
    jp, jq = _jax_interpret_extremes(v, XW, yW)
    np.testing.assert_array_equal(i_p.numpy(), jp)
    np.testing.assert_array_equal(i_q.numpy(), jq)
    has_p, has_q = (yW == 1).any(dim=2), (yW == -1).any(dim=2)
    assert torch.equal(e.has_p, has_p) and torch.equal(e.has_q, has_q)
    rows = np.arange(X.shape[0])[:, None], np.arange(X.shape[1])[None, :]
    assert torch.equal(e.p, XW[rows + (i_p.long(),)])
    assert torch.equal(e.q, XW[rows + (i_q.long(),)])
    for edge, row, has, absent in ((e.lo, e.p, has_p, -np.inf),
                                   (e.hi, e.q, has_q, np.inf)):
        want = torch.where(has, row[..., 0] * v[:, None, 0]
                           + row[..., 1] * v[:, None, 1], absent)
        assert torch.equal(edge, want)
    assert not bool(e.has_p[2, 2] or e.has_q[2, 2])
    assert int(e.i_p[2, 2]) == int(e.i_q[2, 2]) == 0
    assert bool(e.has_q[1, 0]) and int(e.i_q[1, 0]) < n
    if W > n:
        assert bool(e.has_p[0, 1]) and int(e.i_p[0, 1]) >= n


def test_extremes_segments_ties_across_the_boundary_go_to_the_own_row():
    """A transcript that is an exact copy of the own rows ties every
    extreme across the boundary: both indices stay in the own segment."""
    v, X, y, _, _, _ = chip_smoke.crafted_segment_inputs("cpu", 5, n=40)
    e = kernels.median_extremes_segments_plain(v, X, y, X.clone(), y.clone(),
                                               40)
    own_p, own_q = kernels.median_extremes_plain(v, X, y)
    assert torch.equal(e.i_p, own_p) and torch.equal(e.i_q, own_q)
    assert bool((e.i_p < 40).all() and (e.i_q < 40).all())


def test_extremes_segments_wrapper_takes_the_plain_version_on_cpu():
    kernels.reset_launches()
    args = chip_smoke.crafted_segment_inputs("cpu", 6)
    got = kernels.median_extremes_segments(*args)
    want = kernels.median_extremes_segments_plain(*args)
    assert type(got) is kernels.Extremes
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert kernels.launches()["median_extremes"] == 0
    meta = [a.to("meta") for a in args[:5]]
    with pytest.raises(ValueError, match="cuda or cpu"):
        kernels.median_extremes_segments(*meta, args[5])


def test_extremes_arguments_refuse_what_the_kernel_does_not_take():
    v, X, y, wx, wy, W = chip_smoke.crafted_segment_inputs("cpu", 7)
    check = support_margin.check_extremes_args
    assert check(v, X, y, wx, wy, W) == (5, 3, 41, 48)
    assert check(v, X, y) == (5, 3, 41, 0)
    for bad in [(v.double(), X, y, wx, wy, W), (v, X, y.long(), wx, wy, W),
                (v, X, y, wx.half(), wy, W)]:
        with pytest.raises(TypeError):
            check(*bad)
    for bad in [(v, X, y, wx, wy, 49),                    # past capacity
                (v, X, y, wx, wy, -1),
                (v, X, y, wx[:1], wy, W),
                (v, X[:, :, :0], y[:, :, :0], wx, wy, 0),   # no rows
                (v, X, y, wx.transpose(0, 1).contiguous().transpose(0, 1),
                 wy, W)]:
        with pytest.raises(ValueError):
            check(*bad)
    shifted = torch.zeros(X.numel() + 1)[1:].view(X.shape)   # 4-byte aligned
    with pytest.raises(ValueError, match="8-byte"):
        check(v, shifted, y, wx, wy, W)


def test_cut_plain_chunking_changes_nothing(monkeypatch):
    args = tuple(map(torch.from_numpy, _cut_inputs(7, B=9)))
    whole = kernels.median_cut_scores_plain(*args)
    monkeypatch.setattr(median_cut, "_PLAIN_CHUNK", 2 * 128 * 48)
    assert torch.equal(kernels.median_cut_scores_plain(*args), whole)


def test_wrappers_take_plain_versions_on_cpu_without_launching():
    kernels.reset_launches()
    cut = tuple(map(torch.from_numpy, _cut_inputs(4)))
    ext = tuple(map(torch.from_numpy, _extremes_inputs(4)))
    turn = tuple(map(torch.from_numpy, _turn_inputs(4)))
    stage = tuple(map(torch.from_numpy, _stage_inputs(4)))
    assert torch.equal(kernels.median_cut_scores(*cut),
                       kernels.median_cut_scores_plain(*cut))
    for a, b in zip(kernels.median_extremes(*ext),
                    kernels.median_extremes_plain(*ext)):
        assert torch.equal(a, b)
    for a, b in zip(kernels.maxmarg_turn_scan(*turn),
                    kernels.maxmarg_turn_scan_plain(*turn)):
        assert torch.equal(a, b)
    for a, b in zip(kernels.pegasos_stage(*stage, nsteps=7, t0=3.0),
                    kernels.pegasos_stage_plain(*stage, nsteps=7, t0=3.0)):
        assert torch.equal(a, b)
    V, ok, lo, hi, X, y = cut
    for a, b in zip(kernels.threshold_ranges(V, X, y),
                    kernels.threshold_ranges_plain(V, X, y)):
        assert torch.equal(a, b)
    assert torch.equal(kernels.uncertain_mask(*cut),
                       kernels.uncertain_mask_plain(*cut))
    q, kv = torch.ones((1, 5, 4, 32)), torch.ones((1, 7, 2, 32))
    assert torch.equal(kernels.attention(q, kv, kv, causal=True),
                       kernels.attention_plain(q, kv, kv, causal=True))
    assert kernels.launches() == {"median_cut_scores": 0,
                                  "median_extremes": 0,
                                  "maxmarg_turn_scan": 0,
                                  "pegasos_stage": 0,
                                  "threshold_ranges": 0,
                                  "uncertain_mask": 0,
                                  "attention": 0,
                                  "rwkv6": 0,
                                  "mamba_scan": 0}


def test_wrappers_refuse_other_devices():
    cut = [torch.from_numpy(a).to("meta") for a in _cut_inputs(0)]
    with pytest.raises(ValueError, match="cuda or cpu"):
        kernels.median_cut_scores(*cut)
    ext = [torch.from_numpy(a).to("meta") for a in _extremes_inputs(0)]
    with pytest.raises(ValueError, match="cuda or cpu"):
        kernels.median_extremes(*ext)
    turn = [torch.from_numpy(a).to("meta") for a in _turn_inputs(0)]
    with pytest.raises(ValueError, match="cuda or cpu"):
        kernels.maxmarg_turn_scan(*turn)
    stage = [torch.from_numpy(a).to("meta") for a in _stage_inputs(0)]
    with pytest.raises(ValueError, match="cuda or cpu"):
        kernels.pegasos_stage(*stage, nsteps=3)
    V, ok, lo, hi, X, y = cut
    with pytest.raises(ValueError, match="cuda or cpu"):
        kernels.threshold_ranges(V, X, y)
    with pytest.raises(ValueError, match="cuda or cpu"):
        kernels.uncertain_mask(*cut)
    q = torch.ones((1, 5, 4, 32), device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        kernels.attention(q, q, q, causal=True)


def test_build_targets_hopper_without_fma():
    """The kernels' rounding relies on no contraction into FMA."""
    flags = " ".join(_build.NVCC_FLAGS)
    assert "arch=compute_90a,code=sm_90a" in flags
    assert "--fmad=false" in flags
    sources = sorted(p.name for p in _build.CSRC.glob("*.cu"))
    assert sources == ["flash_attention.cu", "flash_attention_splitkv.cu",
                       "flash_attention_tc.cu", "mamba_scan.cu",
                       "maxmarg_turn.cu", "median_cut.cu",
                       "median_extremes.cu", "pegasos_stage.cu",
                       "rwkv6.cu", "threshold_ranges.cu",
                       "uncertain_mask.cu"]
    for name in sources:
        text = (_build.CSRC / name).read_text()
        assert "__fmul_rn" in text and "__fadd_rn" in text
    paths = [_build.library_path(p[:-3]) for p in sources]
    assert len({p.parent for p in paths}) == 1
    assert len(set(paths)) == 11 and all(p.suffix == ".so" for p in paths)


# -- the cut scan kernel's label flip ---------------------------------------

def _flipped_cut(V, dir_ok, lo, hi, X, y):
    """The CUDA cut scan's risk test in f32: a negative point staged
    negated and tested as fl(fl(v0*(-x0)) + fl(v1*(-x1))) > -hi_r, a
    positive one as p > lo_r, then the plain version's histograms.  Returns
    (scores, risk)."""
    B, m = dir_ok.shape
    nonempty = (lo < hi) & dir_ok
    lo_r = lo.masked_fill(~nonempty, np.inf)
    nhi_r = (-hi).masked_fill(~nonempty, np.inf)
    neg = (y != 0) & (y != 1)
    Xs = torch.where(neg[..., None], -X, X)
    p = (V[None, :, None, 0] * Xs[:, None, :, 0]
         + V[None, :, None, 1] * Xs[:, None, :, 1])           # (B, m, n)
    risk = p > torch.where(neg[:, None, :], nhi_r[:, :, None],
                           lo_r[:, :, None])
    idx = torch.arange(m, dtype=torch.int32)[None, :, None]
    last = torch.where(risk, idx, -1).amax(dim=1)
    first = torch.where(risk, idx, m).amin(dim=1)
    live = ((last >= 0) & (y != 0)).to(torch.int32)
    zeros = torch.zeros((B, m), dtype=torch.int32)
    below = torch.cumsum(zeros.scatter_add(1, last.clamp(0, m - 1).long(),
                                           live), dim=1, dtype=torch.int32)
    above = (live.sum(dim=1, dtype=torch.int32)[:, None]
             - torch.cumsum(zeros.scatter_add(
                 1, first.clamp(0, m - 1).long(), live), dim=1,
                 dtype=torch.int32))
    return torch.where(dir_ok, torch.minimum(below, above), -1), risk


def _plain_risk(V, dir_ok, lo, hi, X, y):
    nonempty = (lo < hi) & dir_ok
    lo_r = lo.masked_fill(~nonempty, np.inf)
    hi_r = hi.masked_fill(~nonempty, -np.inf)
    p = (V[None, :, None, 0] * X[:, None, :, 0]
         + V[None, :, None, 1] * X[:, None, :, 1])
    return torch.where((y == 1)[:, None, :], p > lo_r[:, :, None],
                       p < hi_r[:, :, None])


@pytest.mark.parametrize("seed,B,m,n", [(0, 6, 64, 40), (1, 6, 31, 33),
                                        (2, 4, 33, 9), (3, 1, 97, 50)])
def test_cut_label_flip_matches_plain(seed, B, m, n):
    """Negating a negative point and its bound gives the plain test bit for
    bit: at ±0 points and bounds, ±inf bounds, bounds on a point's own
    projection (ties), both labels, one-label and padding-only rows."""
    args = chip_smoke.edge_cut_inputs(
        tgeo, torch.device("cpu"), B, m, n, seed=seed)
    V, dir_ok, lo, hi, X, y = args
    y = y.clone()
    y[0, :3] = torch.tensor([1, -1, 0], dtype=torch.int32)[:min(3, n)]
    args = (V, dir_ok, lo, hi, X, y)
    got, risk = _flipped_cut(*args)
    assert torch.equal(risk & (y != 0)[:, None, :],
                       _plain_risk(*args) & (y != 0)[:, None, :])
    assert torch.equal(got, kernels.median_cut_scores_plain(*args))


def test_cut_label_flip_on_signed_zeros_and_infinities():
    """Every pairing of a ±0 / ±inf / ±1 coordinate with a ±0 / ±inf / ±1
    bound, both labels and both signs of zero in the second coordinate."""
    vals = [0.0, -0.0, np.inf, -np.inf, 1.0, -1.0]
    cases = [(a, z, b, lab) for a in vals for z in (0.0, -0.0)
             for b in vals for lab in (1, -1)]
    V = torch.tensor([[1.0, 0.0], [1.0, -0.0]])
    X = torch.tensor([[[a, z]] for a, z, _, _ in cases])      # (N, 1, 2)
    y = torch.tensor([[lab] for *_, lab in cases], dtype=torch.int32)
    bound = torch.tensor([[b, b] for _, _, b, _ in cases])
    inf = torch.full_like(bound, np.inf)
    # positives meet their bound in lo, negatives in hi
    lo = torch.where(y == 1, bound, -inf)
    hi = torch.where(y == 1, inf, bound)
    dir_ok = torch.ones((len(cases), 2), dtype=torch.bool)
    got, risk = _flipped_cut(V, dir_ok, lo, hi, X, y)
    assert torch.equal(risk, _plain_risk(V, dir_ok, lo, hi, X, y))
    assert risk.any() and not risk.all()
    assert torch.equal(got, kernels.median_cut_scores_plain(
        V, dir_ok, lo, hi, X, y))


def test_kernel_argument_checks_refuse_what_the_kernels_do_not_take():
    cut = [torch.from_numpy(a) for a in _cut_inputs(0)]
    assert median_cut.check_kernel_args(*cut) == (5, 128, 48)
    for i, bad in [(0, torch.float64), (2, torch.float16), (4, torch.float64),
                   (5, torch.int64), (1, torch.uint8)]:
        args = list(cut)
        args[i] = args[i].to(bad)
        with pytest.raises(TypeError):
            median_cut.check_kernel_args(*args)
    args = list(cut)
    args[4] = args[4].transpose(0, 1).contiguous().transpose(0, 1)
    with pytest.raises(ValueError, match="contiguous"):
        median_cut.check_kernel_args(*args)
    args = list(cut)
    args[4] = torch.zeros(args[4].numel() + 1)[1:].view(args[4].shape)
    with pytest.raises(ValueError, match="8-byte"):
        median_cut.check_kernel_args(*args)
    V = torch.zeros((median_cut._MAX_ANGLES + 1, 2))
    with pytest.raises(ValueError, match="unsupported shape"):
        median_cut.check_kernel_args(
            V, torch.ones((1, len(V)), dtype=torch.bool),
            torch.zeros((1, len(V))), torch.zeros((1, len(V))), cut[4][:1],
            cut[5][:1])
