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
    V, X, y = cut[0], cut[4], cut[5]
    assert support_margin.check_ranges_args(V, X, y) == (5, 128, 48, 2)
    with pytest.raises(TypeError):
        support_margin.check_ranges_args(V, X, y.to(torch.int64))
    with pytest.raises(ValueError, match="8-byte"):
        support_margin.check_ranges_args(
            V, torch.zeros(X.numel() + 1)[1:].view(X.shape), y)


# -- the turn kernel's selection: per-lane lists, merged ---------------------

def _before(a, b):
    """The kernel's (margin, index) order."""
    return a[0] < b[0] or (a[0] == b[0] and a[1] < b[1])


def _lane_lists(key, valid, lanes, cap, floor):
    """Each of ``lanes`` lanes walks rows lane, lane + lanes, ... and keeps
    its ``cap`` smallest (margin, index) pairs among valid rows with a
    finite margin after ``floor``, sorted, as the kernel's register list."""
    lists = []
    for lane in range(lanes):
        kept = []
        for i in range(lane, len(key), lanes):
            c = (float(key[i]), i)
            if not (valid[i] and c[0] < np.inf and _before(floor, c)):
                continue
            if len(kept) == cap and not _before(c, kept[-1]):
                continue
            t = 0
            while t < len(kept) and not _before(c, kept[t]):
                t += 1
            kept = (kept[:t] + [c] + kept[t:])[:cap]
        lists.append(kept)
    return lists


def _merge(lists, cap):
    """``cap`` rounds of an argmin over the lists' heads, the winner popping
    its head: the kernel's shuffle merge (a warp's lanes, then a team's
    warps)."""
    heads = [list(x) for x in lists]
    out = []
    for _ in range(cap):
        live = [h for h in heads if h]
        if not live:
            break
        best = min(live, key=lambda h: h[0])
        out.append(best.pop(0))
    return out


def _replica_segment(key, valid, r, cap, team, band_scale=None):
    """One segment's ranks as the kernel forms them: per-lane lists over a
    lane-strided walk by a team of ``team`` warps, each warp's lanes merged,
    then the team's warps; for the fit set (``band_scale`` given) the band
    edge from the merged list's first margin.  Ranks beyond ``cap`` take
    further passes after the last pair ranked."""
    n = len(key)
    ranks = np.full(n, n, np.int32)
    thr, floor, base = np.float32(np.inf), (-np.inf, -1), 0
    while True:
        lanes = _lane_lists(key, valid, 32 * team, cap, floor)
        warps = [_merge(lanes[32 * w:32 * w + 32], cap) for w in range(team)]
        m = _merge(warps, cap)
        if base == 0 and band_scale is not None:
            mmin = np.float32(m[0][0] if m else np.inf)
            thr = np.maximum(mmin, np.float32(1e-12)) * band_scale
        placed = 0
        for t, (kt, it) in enumerate(m):
            if base + t < r and kt <= thr:
                ranks[it] = base + t
                placed += 1
        if not (placed == cap and base + cap < r):
            return ranks
        floor, base = m[-1], base + cap


def _list_cap(max_support, viol_ship):
    r = max(max_support, viol_ship)
    return 1 if r <= 1 else 2 if r <= 2 else 4 if r <= 4 else 8


def _turn_replica(w, b, K, yK, X, y, *, rtol=0.15, max_support=4,
                  viol_ship=2, team=1):
    """numpy replica of ``csrc/maxmarg_turn.cu``: margins rounded once per
    operation, left to right over d, then each segment's selection."""
    def dec(P, wi, bi):
        s = P[..., 0] * wi[0]
        for c in range(1, P.shape[-1]):
            s = s + P[..., c] * wi[c]
        return s + bi

    cap = _list_cap(max_support, viol_ship)
    scale = np.float32(1.0 + rtol)
    B, N, _ = K.shape
    k, n = y.shape[1:]
    sup = np.empty((B, N), np.int32)
    err = np.empty((B, k), np.int32)
    viol = np.empty((B, k, n), np.int32)
    for i in range(B):
        mK = yK[i].astype(np.float32) * dec(K[i], w[i], b[i])
        sup[i] = _replica_segment(mK, yK[i] != 0, max_support, cap, team,
                                  scale)
        for j in range(k):
            dj = dec(X[i, j], w[i], b[i])
            lab = y[i, j]
            err[i, j] = int(((lab != 0) & (np.where(dj > 0, 1, -1)
                                           != lab)).sum())
            viol[i, j] = _replica_segment(lab.astype(np.float32) * dj,
                                          lab != 0, viol_ship, cap, team)
    return sup, err, viol


def _few_in_band(seed):
    """Fit sets whose band holds fewer rows than max_support while many
    more valid rows lie outside it; margins are exact copies of the first
    coordinate (w = (1, 0), b = 0), so JAX's dot forms them alike."""
    rng = np.random.default_rng(seed)
    B, N, k, n = 3, 75, 2, 43
    w = np.tile(np.float32([1.0, 0.0]), (B, 1))
    b = np.zeros(B, np.float32)
    K = rng.normal(size=(B, N, 2)).astype(np.float32)
    yK = np.where(rng.random((B, N)) < 0.5, 1, -1).astype(np.int32)
    m = rng.uniform(2.0, 4.0, (B, N)).astype(np.float32)
    m[:, [5, 40]] = np.float32(1.0)                  # two rows in the band
    m[1, 60] = np.float32(1.0) * np.float32(1.15)    # a third on its edge
    yK[2, ::3] = 0
    K[..., 0] = yK * m
    X = rng.normal(size=(B, k, n, 2)).astype(np.float32)
    y = np.where(rng.random((B, k, n)) < 0.5, 1, -1).astype(np.int32)
    X[..., 0] = y * rng.choice(np.float32([-0.5, 0.25, 0.25, 1.0]), (B, k, n))
    return w, b, K, yK, X, y


_TURN_CASES = {
    "ties0": lambda: chip_smoke.crafted_turn_inputs("cpu", 0),
    "ties1": lambda: chip_smoke.crafted_turn_inputs("cpu", 1),
    "ties2": lambda: chip_smoke.crafted_turn_inputs("cpu", 2),
    "few_in_band": lambda: _few_in_band(4),
}


@pytest.mark.parametrize("case,max_support,viol_ship,team", [
    ("ties0", 4, 2, 1), ("ties1", 4, 2, 1), ("ties2", 4, 2, 1),
    ("ties0", 0, 0, 1), ("ties1", 1, 1, 1), ("ties2", 8, 8, 1),
    ("ties0", 4, 2, 2), ("ties1", 8, 3, 8), ("ties2", 1, 4, 2),
    ("ties0", 12, 2, 1), ("ties1", 3, 17, 2),
    ("few_in_band", 4, 2, 1), ("few_in_band", 8, 2, 2),
    ("few_in_band", 1, 8, 1), ("few_in_band", 0, 4, 8),
])
def test_turn_kernel_selection_replica_is_bit_for_bit(case, max_support,
                                                      viol_ship, team):
    """The kernel's one-pass selection, replicated in numpy (per-lane lists
    over a walk whose lane count does not divide N or n, merged lanes then
    warps, the band cut from the merged list, further passes above the
    list's capacity), equals the plain version and JAX's
    ``ref.maxmarg_turn_batch_ref`` on every tie ``crafted_turn_inputs``
    holds and on bands with fewer rows than max_support."""
    args = tuple(np.asarray(a) for a in _TURN_CASES[case]())
    opts = dict(max_support=max_support, viol_ship=viol_ship)
    got = _turn_replica(*args, team=team, **opts)
    plain = kernels.maxmarg_turn_scan_plain(*map(torch.from_numpy, args),
                                            **opts)
    jref = ref.maxmarg_turn_batch_ref(*args, **opts)
    for g, p, e in zip(got, plain, jref):
        np.testing.assert_array_equal(g, p.numpy())
        np.testing.assert_array_equal(g, np.asarray(e))
    if case == "few_in_band" and max_support >= 4:
        # only the band's rows are ranked, though more valid rows exist
        assert (got[0] < args[2].shape[1]).sum(1).tolist() == [2, 3, 2]


@pytest.mark.parametrize("seed,B,N,k,n,d", [(0, 3, 50, 3, 30, 3),
                                            (1, 2, 97, 2, 33, 2),
                                            (2, 2, 40, 4, 65, 16)])
def test_turn_kernel_selection_replica_on_random_rows(seed, B, N, k, n, d):
    """General position at d = 2, 3 and 16 (the kernel's pair path and its
    any-d path compute the same margins): replica and plain version agree
    for a warp and for teams."""
    args = _turn_inputs(seed, B, N, k, n, d)
    plain = kernels.maxmarg_turn_scan_plain(*map(torch.from_numpy, args))
    for team in (1, 2, 8):
        for g, p in zip(_turn_replica(*args, team=team), plain):
            np.testing.assert_array_equal(g, p.numpy())


def test_turn_arguments_refuse_what_the_kernel_does_not_take():
    args = list(map(torch.from_numpy, _turn_inputs(0, d=2)))
    check = support_margin.check_turn_args
    assert check(*args) == (4, 50, 3, 30, 2)
    for i, bad in [(0, torch.float64), (1, torch.float16), (2, torch.float64),
                   (3, torch.int64), (4, torch.bfloat16), (5, torch.int16)]:
        a = list(args)
        a[i] = a[i].to(bad)
        with pytest.raises(TypeError):
            check(*a)
    for i, bad in [(0, args[0][:, :1]), (1, args[1][:3]),
                   (3, args[3][:, :7]), (5, args[5][:, :2])]:
        a = list(args)
        a[i] = bad
        with pytest.raises(ValueError):
            check(*a)
    with pytest.raises(ValueError, match="unsupported shape"):
        check(*args, max_support=-1)
    with pytest.raises(ValueError, match="unsupported shape"):
        check(*args, viol_ship=-2)
    wide = list(map(torch.from_numpy, _turn_inputs(
        0, B=1, N=2, k=1, n=2, d=support_margin._MAX_TURN_D + 1)))
    with pytest.raises(ValueError, match="unsupported shape"):
        check(*wide)
    a = list(args)
    a[2] = a[2].transpose(1, 2).contiguous().transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        check(*a)
    a = list(args)
    a[4] = torch.zeros(a[4].numel() + 1)[1:].view(a[4].shape)  # 4-byte
    with pytest.raises(ValueError, match="8-byte"):
        check(*a)
    odd = list(map(torch.from_numpy, _turn_inputs(0, d=3)))
    odd[2] = torch.zeros(odd[2].numel() + 1)[1:].view(odd[2].shape)
    assert check(*odd) == (4, 50, 3, 30, 3)   # pairs only at d = 2


# -- the SOU kernel's direction-parallel test --------------------------------

def _sou_replica(V, dir_ok, lo, hi, X, y, cap=1024, parts=1, width=128):
    """numpy replica of ``csrc/uncertain_mask.cu``: per chunk of ``cap``
    grid directions, the nonempty allowed ones compacted in grid order as
    (v, lo, -hi) and padded with slots no point passes to a multiple of
    ``width``; each point staged (negated unless labelled +1) and tested
    ``width`` directions a round against lo or -hi, stopping at the first
    round with a hit; points split over ``parts`` blocks.  (The kernel
    tests a chunk of at most one round's directions point-parallel, in
    grid order to each point's first hit: the same mask.)  Returns (mask,
    slots tested)."""
    B, m = dir_ok.shape
    n = X.shape[1]
    out = np.zeros((B, n), bool)
    tested = 0
    per = -(-n // parts)
    for bi in range(B):
        for j0 in range(0, m, cap):
            js = [j for j in range(j0, min(m, j0 + cap))
                  if dir_ok[bi, j] and lo[bi, j] < hi[bi, j]]
            rounds = -(-len(js) // width)
            pad = rounds * width - len(js)
            Vc = np.concatenate([V[js], np.zeros((pad, V.shape[1]),
                                                 np.float32)])
            lo_c = np.concatenate([lo[bi, js], np.full(pad, np.inf,
                                                       np.float32)])
            nhi_c = np.concatenate([-hi[bi, js], np.full(pad, np.inf,
                                                         np.float32)])
            for part in range(parts):
                for i in range(part * per, min(n, (part + 1) * per)):
                    if out[bi, i]:
                        continue
                    pos = y[bi, i] == 1
                    x = X[bi, i] if pos else -X[bi, i]
                    bound = lo_c if pos else nhi_c
                    for g in range(rounds):
                        sl = slice(width * g, width * g + width)
                        p = Vc[sl, 0] * x[0]
                        for c in range(1, V.shape[1]):
                            p = p + Vc[sl, c] * x[c]
                        tested += width
                        if (p > bound[sl]).any():
                            out[bi, i] = True
                            break
    return out, tested


@pytest.mark.parametrize("seed,d,cap,parts", [
    (0, 2, 1024, 1), (1, 2, 1024, 3), (0, 3, 1024, 1), (1, 3, 256, 2),
    (2, 2, 128, 1), (3, 5, 128, 4),
])
def test_sou_kernel_replica_is_exact_on_band_edges(seed, d, cap, parts):
    """Points sitting exactly on band edges built from their own
    projections (``crafted_scan_inputs``): the negated test against -hi,
    the compaction, the inert padding, rounds of 128, chunks of directions
    (points that hit in an earlier chunk skipped) and points split over
    blocks give the plain version's mask exactly."""
    V, ok, lo, hi, X, y, _, _ = chip_smoke.crafted_scan_inputs("cpu", seed,
                                                               d)
    got, _ = _sou_replica(*(a.numpy() for a in (V, ok, lo, hi, X, y)),
                          cap=cap, parts=parts)
    want = kernels.uncertain_mask_plain(V, ok, lo, hi, X, y)
    np.testing.assert_array_equal(got, want.numpy())
    assert want.any() and not want.all()


@pytest.mark.parametrize("seed,d", [(0, 2), (1, 3)])
def test_sou_kernel_replica_matches_jax_and_counts_its_tests(seed, d):
    """General position against JAX's ``ref.uncertain_mask_batch_ref``; the
    slots the replica tests are at least the bound's tests (every test up
    to a point's first hit in grid order) and at most 127 a point more."""
    V, ok, lo, hi, X, y = _cut_inputs(seed)
    if d != 2:
        rng = np.random.default_rng(seed)
        V = rng.normal(size=(V.shape[0], d)).astype(np.float32)
        X = rng.normal(size=X.shape[:2] + (d,)).astype(np.float32)
    got, tested = _sou_replica(V, ok, lo, hi, X, y)
    want = ref.uncertain_mask_batch_ref(*map(jnp.asarray,
                                             (V, ok, lo, hi, X, y)))
    np.testing.assert_array_equal(got, np.asarray(want))
    tests, _, rounds = chip_smoke._uncertain_work(
        *map(torch.from_numpy, (V, ok, lo, hi, X, y)))
    points = X.shape[0] * X.shape[1]
    live = [int(((lo[b] < hi[b]) & ok[b]).sum()) > 0 for b in range(len(ok))]
    assert tests <= tested == 128 * rounds <= tests + 127 * points
    assert any(live) and not all(live)


def test_uncertain_arguments_refuse_what_the_kernel_does_not_take():
    args = list(map(torch.from_numpy, _cut_inputs(0)))
    check = support_margin.check_uncertain_args
    assert check(*args) == (5, 128, 48, 2)
    for i, bad in [(0, torch.float64), (1, torch.uint8), (2, torch.float16),
                   (3, torch.float64), (4, torch.float64), (5, torch.int64)]:
        a = list(args)
        a[i] = a[i].to(bad)
        with pytest.raises(TypeError):
            check(*a)
    for i, bad in [(1, args[1][:, :5]), (2, args[2][:2]), (4, args[4][:, :, :1])]:
        a = list(args)
        a[i] = bad
        with pytest.raises(ValueError):
            check(*a)
    wide = torch.zeros((3, support_margin._MAX_SCAN_D + 1))
    with pytest.raises(ValueError, match="unsupported shape"):
        check(wide, args[1][:, :3], args[2][:, :3], args[3][:, :3],
              torch.zeros((5, 48, wide.shape[1])), args[5])
    a = list(args)
    a[2] = a[2].t().contiguous().t()
    with pytest.raises(ValueError, match="contiguous"):
        check(*a)
    a = list(args)
    a[0] = torch.zeros(a[0].numel() + 1)[1:].view(a[0].shape)   # 4-byte
    with pytest.raises(ValueError, match="8-byte"):
        check(*a)


# -- the ranges kernel: row groups, chunks and its merge order --------------

def _ranges_jax_ok(got, want, Xw):
    """tests/test_torch_dataplane.py's ``_assert_ranges`` rule, the Pallas
    kernel's ±1e30 sentinels read as ±inf: the same infinities, finite
    values to rtol 1e-6 and, since JAX's dot sums the d products in
    another order (with fused multiply-adds), to d·eps·max‖x‖: two orders
    of a sum of d products differ by at most d·eps·Σ|v_c x_c|, and
    Σ|v_c x_c| <= ‖x‖ for a unit direction."""
    Xw = np.asarray(Xw)
    atol = (Xw.shape[-1] * np.finfo(np.float32).eps
            * float(np.linalg.norm(Xw, axis=-1).max(initial=0.0)))
    for g, w in zip(got, want):
        w = np.asarray(w)
        w = np.where(w <= -5e29, -np.inf, np.where(w >= 5e29, np.inf, w))
        fin = np.isfinite(w)
        np.testing.assert_array_equal(np.isfinite(g), fin)
        np.testing.assert_array_equal(g[~fin], w[~fin])
        np.testing.assert_allclose(g[fin], w[fin], rtol=1e-6, atol=atol)


def _ranges_case(d):
    """``chip_smoke.crafted_ranges_inputs`` with rows over two or more
    chunks of the kernel's shared memory (1024 rows at d = 2 and 3, 64 at
    d = 64)."""
    n = 392 if d == 64 else 1100
    V, Xw, yw = chip_smoke.crafted_ranges_inputs("cpu", 0, d, n=n)
    chunk = support_margin.ranges_chunk(d, n)
    assert n > chunk
    return V, Xw, yw, chunk


@pytest.mark.parametrize("warps", [8, 2, 1])
@pytest.mark.parametrize("B", [1, 5])
@pytest.mark.parametrize("d", [2, 3, 64])
def test_ranges_kernel_replica_is_exact_on_crafted_edges(d, B, warps):
    """The replica of the kernel's order (row groups of ``warps`` warps,
    chunks, the +1 and -1 lists, strict merges) against the plain version
    under == (infinities and zeros of either sign included) and against
    JAX's ``ref.threshold_ranges_batch_ref``, batched (B=5) and on each
    instance alone (B=1): a 384-row transcript beside 4-row ones, rows
    interleaved with padding, a class absent, padding only, m = 203, rows
    over several chunks, ±0 maxima and minima."""
    V, Xw, yw, chunk = _ranges_case(d)
    jlo, jhi = ref.threshold_ranges_batch_ref(
        *(jnp.asarray(a.numpy()) for a in (V, Xw, yw)))
    for b0 in (range(5) if B == 1 else [0]):
        sl = slice(b0, b0 + B)
        got = chip_smoke.ranges_replica(V.numpy(), Xw[sl].numpy(),
                                        yw[sl].numpy(), 8 // warps, chunk)
        want = kernels.threshold_ranges_plain(V, Xw[sl], yw[sl])
        for g, w in zip(got, want):
            assert g.dtype == np.float32
            np.testing.assert_array_equal(g, w.numpy())
        _ranges_jax_ok(got, (np.asarray(jlo)[sl], np.asarray(jhi)[sl]),
                       Xw[sl])
    if B == 5:
        assert np.isinf(got[0][[1, 3]]).all()      # no +1 row, padding only
        assert np.isinf(got[1][3]).all() and np.isfinite(got[1][0]).all()
        for b in (2, 4):     # ±0 maxima and minima on the first axis
            assert (got[0][b, [0, 5]] == 0).all()
            assert (got[1][b, [0, 5]] == 0).all()


@pytest.mark.parametrize("d", [2, 3, 64])
def test_ranges_kernel_replica_matches_pallas_in_interpret_mode(d):
    """``threshold_ranges_batched`` and, on instance 2 (the ±0 one), the
    single-instance ``threshold_ranges`` through the JAX package's
    wrappers in interpret mode, as tests/test_torch_dataplane.py runs
    them."""
    from jax.experimental.pallas import tpu as pltpu
    import contextlib
    V, Xw, yw, chunk = _ranges_case(d)
    got = chip_smoke.ranges_replica(V.numpy(), Xw.numpy(), yw.numpy(), 1,
                                    chunk)
    ctx = (pltpu.force_tpu_interpret_mode()
           if hasattr(pltpu, "force_tpu_interpret_mode")
           else contextlib.nullcontext())
    with ctx:
        want = ops.support_ranges_batch(
            *(jnp.asarray(a.numpy()) for a in (V, Xw, yw)), interpret=True)
        one = ops.support_ranges(
            *(jnp.asarray(a.numpy()) for a in (V, Xw[2], yw[2])),
            interpret=True)
    _ranges_jax_ok(got, want, Xw)
    _ranges_jax_ok((got[0][2], got[1][2]), one, Xw[2])


def test_ranges_replica_signs_of_zero_follow_the_merge_order():
    """On direction 0 (the first axis) instance 2's +1 rows project to
    (negative, +0, negative x 6, -0) and its -1 rows to (positive, -0,
    positive x 6, +0), all in one chunk: one row group meets the second
    row first and keeps its zero; with 2, 4 or 8 groups group 0 holds
    the first and the ninth rows (places 0 and 8) and its zero is met
    first in the merge.  Equal values under ==, other bits."""
    V, Xw, yw = (a.numpy() for a in chip_smoke.crafted_ranges_inputs(
        "cpu", 0, 2))
    chunk = support_margin.ranges_chunk(2, Xw.shape[1])
    signs = {}
    for groups in (1, 2, 4, 8):
        lo, hi = chip_smoke.ranges_replica(V, Xw, yw, groups, chunk)
        assert lo[2, 0] == 0 and hi[2, 0] == 0
        signs[groups] = (bool(np.signbit(lo[2, 0])),
                         bool(np.signbit(hi[2, 0])))
    assert signs == {1: (False, True), 2: (True, False), 4: (True, False),
                     8: (True, False)}


@pytest.mark.parametrize("B,m,n,d,want", [
    (3072, 1024, 392, 2, (8, 4, 1, 392, 3)),    # the SOU path: 1024
    #                                             blocks of 3 instances
    (528, 1024, 392, 2, (4, 4, 2, 392, 1)),     # 1056 blocks fill the card
    (24, 1024, 392, 2, (1, 1, 32, 392, 1)),
    (1, 1024, 392, 2, (1, 1, 32, 392, 1)),      # 32 blocks an instance
    (3072, 128, 392, 2, (1, 4, 1, 392, 3)),     # tiles above 2m passed over
    (5, 203, 1100, 3, (1, 1, 7, 1024, 1)),      # rows over two chunks
    (5, 203, 392, 64, (1, 1, 7, 64, 1)),        # any d: a direction a
    #                                             thread
    (3072, 1024, 392, 5, (8, 1, 4, 392, 3)),    # at most three a block
    (9000, 1024, 2000, 2, (8, 4, 1, 1024, 1)),  # several chunks: one
    (1, 10, 0, 2, (1, 1, 1, 4, 1)),             # no rows
])
def test_ranges_occupancy_is_a_pure_split(B, m, n, d, want):
    got = support_margin.ranges_occupancy(B, m, n, d, sms=132, per_sm=8)
    assert tuple(got[:4]) + (got.per_block,) == want and got.per_sm == 8
    assert got == support_margin.ranges_occupancy(B, m, n, d, sms=132,
                                                  per_sm=8)


def test_ranges_occupancy_covers_every_direction_and_fills_the_card():
    """For any shape: the tiles cover m, a tile is one of the kernel's
    (8, 4, 2 or 1 warps a row group; 4 directions a thread only at d = 2
    and 3), the chunk is a multiple of 4 no larger than 1024 that holds
    all of n when the shared memory allows, the blocks fill the card
    unless the narrowest tile cannot, and a block stages up to three
    instances together, enough to fit the card once, only where the
    transcripts fit one chunk."""
    rng = np.random.default_rng(0)
    for _ in range(400):
        B = int(rng.integers(1, 5000))
        m = int(rng.integers(1, 3000))
        n = int(rng.integers(0, 3000))
        d = int(rng.choice([1, 2, 3, 4, 5, 16, 63, 64]))
        sms, per_sm = int(rng.integers(1, 200)), int(rng.integers(1, 9))
        s = support_margin.ranges_occupancy(B, m, n, d, sms=sms,
                                            per_sm=per_sm)
        tile = 32 * s.warps * s.per_thread
        assert s.warps in (1, 2, 4, 8)
        assert s.per_thread == 1 or (s.per_thread == 4 and d in (2, 3))
        assert s.tiles == -(-m // tile)
        assert s.chunk % 4 == 0 and 4 <= s.chunk <= 1024
        cap = support_margin.ranges_chunk(d)
        assert s.chunk == max(4, min(cap, -(-n // 4) * 4))
        narrowest = s.warps == 1 and s.per_thread == 1
        assert B * s.tiles >= sms * per_sm or narrowest or tile >= 2 * m
        assert 1 <= s.per_block <= 3 and (s.per_block == 1 or n <= s.chunk)
        blocks = -(-B // s.per_block) * s.tiles
        assert blocks <= sms * per_sm or s.per_block == 3 or n > s.chunk
    assert [support_margin.ranges_chunk(d) for d in (2, 3, 5, 64)] == \
        [1024, 1024, 512, 64]


def test_ranges_occupancy_reads_the_card_once(monkeypatch):
    """Without ``sms`` and ``per_sm`` the split reads the card's residency
    through the library's ``threshold_ranges_residency`` once for each d,
    not at every call."""
    import types
    calls = []

    def residency(d, per_thread, chunk, per_block, blocks):
        calls.append((d, per_thread, chunk, per_block))
        blocks._obj.value = 6
        return 0

    monkeypatch.setattr(support_margin, "_RANGES_RESIDENCY", {})
    monkeypatch.setattr(support_margin._build, "bind",
                        lambda stem, entry, args: (None, residency))
    monkeypatch.setattr(support_margin._build, "load", lambda stem: None)
    monkeypatch.setattr(support_margin._build, "check",
                        lambda lib, stem, err: None)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda i: types.SimpleNamespace(
                            multi_processor_count=132))
    for B in (3072, 24, 1, 3072):
        s = support_margin.ranges_occupancy(B, 1024, 392, 2)
        assert s == support_margin.ranges_occupancy(B, 1024, 392, 2,
                                                    sms=132, per_sm=6)
    support_margin.ranges_occupancy(5, 203, 392, 64)
    assert calls == [(2, 4, 1024, 3), (64, 1, 64, 3)]


def test_ranges_arguments_refuse_what_the_kernel_does_not_take():
    V, _, _, _, X, y = map(torch.from_numpy, _cut_inputs(0))
    check = support_margin.check_ranges_args
    assert check(V, X, y) == (5, 128, 48, 2)
    for i, bad in [(0, torch.float64), (1, torch.float16), (2, torch.int64)]:
        a = [V, X, y]
        a[i] = a[i].to(bad)
        with pytest.raises(TypeError):
            check(*a)
    for i, bad in [(1, X[:, :, :1]), (1, X[:2]), (2, y[:, :5])]:
        a = [V, X, y]
        a[i] = bad
        with pytest.raises(ValueError):
            check(*a)
    for args in [(torch.zeros((3, support_margin._MAX_SCAN_D + 1)),
                  torch.zeros((5, 48, support_margin._MAX_SCAN_D + 1)), y),
                 (V, X[:0], y[:0]), (V[:0], X, y)]:
        with pytest.raises(ValueError, match="unsupported shape"):
            check(*args)
    with pytest.raises(ValueError, match="contiguous"):
        check(V, X.transpose(0, 1).contiguous().transpose(0, 1), y)
    X4 = torch.zeros(X.numel() + 1)[1:].view(X.shape)   # 4-byte aligned
    with pytest.raises(ValueError, match="8-byte"):
        check(V, X4, y)
    X3 = torch.zeros(5 * 48 * 3 + 1)[1:].view(5, 48, 3)
    assert check(torch.zeros((7, 3)), X3, y) == (5, 7, 48, 3)   # pairs
    assert check(V, X[:, :0], y[:, :0]) == (5, 128, 0, 2)       # no rows


def _sass(name, ops):
    lines = ["", f"\t\tFunction : {name}"]
    for i, op in enumerate(ops):
        lines.append(f"        /*{16 * i:04x}*/                   {op} ;"
                     f"    /* 0x000000000000000000 */")
    return "\n".join(lines) + "\n"


def test_sass_counters_read_loops_and_vote_rounds():
    """chip_smoke's SASS readers on a listing in ``cuobjdump -sass``'s
    form: the exponentials' loop (the selective scan's count) and the
    median span between votes that test from registers (the SOU kernel's
    rounds; its shared-memory rounds and the divergence fallbacks after
    the exit not counted)."""
    scan = ["MOV R1, c[0x0][0x28]", "MUFU.EX2 R2, R3", "FFMA R4, R2, R5, R6",
            "MUFU.EX2 R7, R8", "ISETP.GE.AND P0, PT, R9, R10, PT",
            "@!P0 BRA 0x10", "EXIT"]
    other = _sass("_Z5otherv", ["NOP", "EXIT"])
    loop, exps, ops = chip_smoke._step_loop(
        other + _sass("_Z10mamba_scanv", scan), "mamba_scan")
    assert (loop, exps) == (5, 2) and ops["MUFU"] == 2 and ops["BRA"] == 1
    rnd = ["FMUL R1, R2, R3", "FMUL R4, R5, R6", "FADD R7, R1, R4",
           "FSETP.GT.AND P0, PT, R7, R8, PT", "VOTE.ANY R9, PT, P0",
           "@P1 BRA 0x200"]
    shared = ["LDS.128 R8, [R9]"] + rnd
    fallback = ["WARPSYNC.COLLECTIVE R11, 0x31f0", "VOTE.ANY R55, PT, P0",
                "ENDCOLLECTIVE", "BSYNC B0"]
    sou = (["VOTE.ANY R0, PT, P2", "LDG.E R1, [R2]"] + rnd * 3
           + ["SHFL.IDX R3, R4, R5, R6"] * 4 + rnd + shared * 2
           + ["EXIT"] + fallback * 9)
    per_round, ops = chip_smoke._vote_round(
        _sass("_Z14uncertain_maskILi2EEvv", sou), "uncertain_maskILi2E")
    assert per_round == len(rnd)
    assert ops["FMUL"] == 2 and ops["VOTE"] == 1 and ops["BRA"] == 1
    with pytest.raises(AssertionError, match="no SASS function"):
        chip_smoke._vote_round(other, "uncertain_mask")
