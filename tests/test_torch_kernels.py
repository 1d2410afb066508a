"""The port's kernel modules on the CPU: the plain PyTorch versions against
the JAX package's jnp twins, and the wrappers' routing.

The CUDA kernels themselves run only on the card; ``chip_smoke.py`` holds
them against these plain versions there.  Here every input is in general
position (random normals, bounds drawn apart from the projections), so the
twins' dot-product projections and the port's one-rounding-per-operation
projections make the same decisions.  Tolerance: integer-exact.  The ties
(bounds built from the scanned points) are held against JAX's inline path
in tests/test_torch_median.py.
"""

import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from repro.core import geometry as jgeo
from repro.kernels import ref

import torch

from repro_torch import kernels
from repro_torch.kernels import _build, median_cut


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


def test_cut_plain_chunking_changes_nothing(monkeypatch):
    args = tuple(map(torch.from_numpy, _cut_inputs(7, B=9)))
    whole = kernels.median_cut_scores_plain(*args)
    monkeypatch.setattr(median_cut, "_PLAIN_CHUNK", 2 * 128 * 48)
    assert torch.equal(kernels.median_cut_scores_plain(*args), whole)


def test_wrappers_take_plain_versions_on_cpu_without_launching():
    kernels.reset_launches()
    cut = tuple(map(torch.from_numpy, _cut_inputs(4)))
    ext = tuple(map(torch.from_numpy, _extremes_inputs(4)))
    assert torch.equal(kernels.median_cut_scores(*cut),
                       kernels.median_cut_scores_plain(*cut))
    for a, b in zip(kernels.median_extremes(*ext),
                    kernels.median_extremes_plain(*ext)):
        assert torch.equal(a, b)
    assert kernels.launches() == {"median_cut_scores": 0,
                                  "median_extremes": 0}


def test_wrappers_refuse_other_devices():
    cut = [torch.from_numpy(a).to("meta") for a in _cut_inputs(0)]
    with pytest.raises(ValueError, match="cuda or cpu"):
        kernels.median_cut_scores(*cut)
    ext = [torch.from_numpy(a).to("meta") for a in _extremes_inputs(0)]
    with pytest.raises(ValueError, match="cuda or cpu"):
        kernels.median_extremes(*ext)


def test_build_targets_hopper_without_fma():
    """The kernels' rounding relies on no contraction into FMA."""
    flags = " ".join(_build.NVCC_FLAGS)
    assert "arch=compute_90a,code=sm_90a" in flags
    assert "--fmad=false" in flags
    sources = sorted(p.name for p in _build.CSRC.glob("*.cu"))
    assert sources == ["median_cut.cu", "median_extremes.cu"]
    for name in sources:
        text = (_build.CSRC / name).read_text()
        assert "__fmul_rn" in text and "__fadd_rn" in text
    a, b = (_build.library_path(s) for s in ("median_cut", "median_extremes"))
    assert a.parent == b.parent and a != b and a.suffix == ".so"
