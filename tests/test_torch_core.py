"""The port's core modules (``repro_torch.core``) against the JAX package's,
and the port's import hygiene.

Tolerances: the numpy copies (datasets, comm) must be bit-identical; the
direction grid within 1 ulp of XLA's f32 cos/sin, with the count of
differing entries printed and bounded; geometry helpers and the
single-instance scans exact on integer and boolean outputs, 1e-6 on floats (the JAX helpers project with a dot,
the port with one rounding per operation).
"""

import ast
import math
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


from repro.core import comm as jcomm, datasets as jdata, geometry as jgeo
from repro.core import sampling as jsamp

import torch

from repro_torch.core import comm as tcomm, datasets as tdata
from repro_torch.core import sampling as tsamp
from repro_torch.core import geometry as tgeo
from repro_torch import kernels as tkern

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"


# -- (a) numpy copies and the direction grid --------------------------------

@pytest.mark.parametrize("module", ["datasets.py", "comm.py", "sampling.py"])
def test_numpy_modules_are_verbatim_copies(module):
    assert ((PORT / "core" / module).read_bytes()
            == (ROOT / "src" / "repro" / "core" / module).read_bytes())


@pytest.mark.parametrize("gen,kw", [
    ("data1", dict(n_per_node=50, k=2, seed=0)),
    ("data2", dict(n_per_node=50, k=3, seed=1)),
    ("data3", dict(n_per_node=50, k=4, seed=2)),
    ("data_mixed_hardness", dict(n_per_node=40, k=4, seed=3)),
    ("data_highd", dict(n_per_node=40, k=2, d=6, seed=4)),
    ("threshold_instance", dict(n=60, k=2, seed=5)),
    ("interval_instance", dict(n=60, k=2, seed=6)),
    ("rectangle_instance", dict(n=60, k=2, d=3, seed=7)),
])
def test_datasets_bit_identical(gen, kw):
    a = getattr(jdata, gen)(**kw)
    b = getattr(tdata, gen)(**kw)
    assert len(a) == len(b)
    for (Xa, ya), (Xb, yb) in zip(a, b):
        assert Xa.dtype == Xb.dtype and ya.dtype == yb.dtype
        np.testing.assert_array_equal(Xa, Xb)
        np.testing.assert_array_equal(ya, yb)


def test_label_noise_bit_identical():
    shards = jdata.data3(n_per_node=80, k=2, seed=9)
    for (Xa, ya), (Xb, yb) in zip(jdata.add_label_noise(shards, 0.1, seed=4),
                                  tdata.add_label_noise(shards, 0.1, seed=4)):
        np.testing.assert_array_equal(Xa, Xb)
        np.testing.assert_array_equal(ya, yb)


@pytest.mark.parametrize("eps", [0.3, 0.1, 0.05, 0.02, 0.005])
def test_sampling_sizes_and_reservoir_identical(eps):
    """ε-net and ε-sample sizes, and a reservoir fed shard by shard from
    the same numpy generator, equal the JAX package's."""
    for vc in (1, 2, 3, 11):
        for c in (jsamp.EPSILON_NET_C, 0.35):
            assert (tsamp.epsilon_net_size(eps, vc, c=c)
                    == jsamp.epsilon_net_size(eps, vc, c=c))
        assert (tsamp.epsilon_sample_size(eps, vc)
                == jsamp.epsilon_sample_size(eps, vc))
    assert tsamp.EPSILON_NET_C == jsamp.EPSILON_NET_C
    cap = tsamp.epsilon_net_size(eps, 3)
    res = [mod.Reservoir(cap, 2, np.random.default_rng(7))
           for mod in (jsamp, tsamp)]
    for shard in tdata.data2(n_per_node=120, k=3, seed=1):
        for r in res:
            r.add_batch(*shard)
            r.add(shard[0][0], int(shard[1][0]))
    for a, b in zip(res[0].sample(), res[1].sample()):
        np.testing.assert_array_equal(a, b)
    assert (res[0].seen, res[0].filled) == (res[1].seen, res[1].filled)
    for a, b in zip(res[0].sample_padded(cap + 5),
                    res[1].sample_padded(cap + 5)):
        np.testing.assert_array_equal(a, b)


def test_comm_wire_accounting_identical():
    for p in range(0, 9, 3):
        for s in range(0, 7, 2):
            for b in range(0, 11, 5):
                for d in (2, 3, 16):
                    assert (jcomm.wire_bytes(p, s, b, d)
                            == tcomm.wire_bytes(p, s, b, d))
                    assert (jcomm.wire_bits(p, s, b, d)
                            == tcomm.wire_bits(p, s, b, d))


@pytest.mark.parametrize("m", [64, 256, 1024])
def test_direction_grid_within_one_ulp(m):
    """θ is reproduced exactly; cos/sin in float64 rounded once to f32 land
    within 1 ulp of XLA's f32 cos/sin, on a few entries."""
    want = np.asarray(jgeo.direction_grid(m))
    got = tgeo.direction_grid(m, device="cpu").numpy()
    assert got.dtype == np.float32 and got.shape == (m, 2)
    ulps = np.abs(got.view(np.int32).astype(np.int64)
                  - want.view(np.int32).astype(np.int64))
    differ = int((ulps > 0).sum())
    print(f"direction_grid({m}): {differ} of {2 * m} entries differ from "
          f"XLA's by 1 ulp")
    assert ulps.max() <= 1
    assert differ <= (2 * m) // 25


# -- geometry helpers and the single-instance scans (B=1 kernel calls) -----

def _geom_inputs(seed, m=128, n=40, nw=12):
    rng = np.random.default_rng(seed)
    V = np.array(jgeo.direction_grid(m))
    Xw = rng.normal(size=(nw, 2)).astype(np.float32)
    yw = rng.choice([-1, 0, 1], size=nw).astype(np.int32)
    X = rng.normal(size=(n, 2)).astype(np.float32)
    y = rng.choice([-1, 1], size=n).astype(np.int32)
    dir_ok = rng.random(m) < 0.7
    return V, dir_ok, Xw, yw, X, y


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_threshold_ranges_and_uncertain_mask(seed):
    V, dir_ok, Xw, yw, X, y = _geom_inputs(seed)
    lo_j, hi_j = jgeo.consistent_threshold_ranges(V, Xw, yw)
    lo_t, hi_t = tkern.threshold_ranges_one(
        *map(torch.from_numpy, (V, Xw, yw)))
    np.testing.assert_allclose(lo_t.numpy(), np.asarray(lo_j), atol=1e-6)
    np.testing.assert_allclose(hi_t.numpy(), np.asarray(hi_j), atol=1e-6)
    want = jgeo.uncertain_mask(V, dir_ok, Xw, yw, X, y)
    tV, tok, tX, ty = map(torch.from_numpy, (V, dir_ok, X, y))
    got = tkern.uncertain_mask_one(tV, tok, lo_t, hi_t, tX, ty)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_threshold_ranges_empty_transcript():
    V = tgeo.direction_grid(16, device="cpu")
    lo, hi = tkern.threshold_ranges_one(
        V, torch.zeros((0, 2)), torch.zeros((0,), dtype=torch.int32))
    assert torch.isneginf(lo).all() and torch.isposinf(hi).all()


def test_margins_and_error():
    rng = np.random.default_rng(3)
    X = rng.normal(size=(50, 2)).astype(np.float32)
    y = rng.choice([-1.0, 1.0], size=50).astype(np.float32)
    w = np.array([0.6, -0.8], np.float32)
    b = np.array(0.1, np.float32)
    np.testing.assert_allclose(
        tgeo.signed_margins(*map(torch.from_numpy, (w, b, X, y))).numpy(),
        np.asarray(jgeo.signed_margins(w, b, X, y)), atol=1e-6)
    assert math.isclose(
        float(tgeo.classification_error(*map(torch.from_numpy,
                                              (w, b, X, y)))),
        float(jgeo.classification_error(w, b, X, y)), abs_tol=1e-7)


@pytest.mark.parametrize("X,y", [
    ([0.0, 5e-324], [1, -1]),
    ([1.0, 1.0000000000000002], [1, -1]),
    ([3.0, 3.0000000000000004], [1, -1]),
    ([1e20], [1]),
], ids=["subnormal", "one", "three", "lone_positive_1e20"])
def test_threshold_fit_zero_error_on_adjacent_doubles(X, y):
    """The midpoint of adjacent doubles, and lo + 1.0 above 2**53, round to
    lo; the port's fit then takes hi (or the next double above lo), so
    every case has error 0.0 (a difference from the reference, ROADMAP
    Queue 3)."""
    from repro_torch.core.classifiers import Threshold
    X = np.asarray(X)
    y = np.asarray(y)
    h = Threshold.fit(X, y)
    assert h.error(X, y) == 0.0, h.t


# -- (g) import hygiene and devices -----------------------------------------

def _port_sources():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _foreign(module: str) -> bool:
    top = module.split(".")[0]
    return top in ("jax", "jaxlib", "repro")


@pytest.mark.parametrize("path", _port_sources(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_source_imports_neither_jax_nor_reference(path):
    tree = ast.parse(path.read_text(encoding="utf-8"))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""] if node.level == 0 else []
        else:
            continue
        assert not any(_foreign(n) for n in names), (path, names)


def test_importing_the_port_loads_no_jax():
    code = (
        "import sys, chip_smoke, repro_torch, repro_torch.core, "
        "repro_torch.engine, repro_torch.kernels, repro_torch.core.protocols, "
        "repro_torch.core.classifiers, repro_torch.engine.maxmarg, "
        "repro_torch.kernels.pegasos, repro_torch.kernels.support_margin, "
        "repro_torch.engine.oneway, repro_torch.core.prng, "
        "repro_torch.core.sampling, repro_torch.core.protocols.baselines, "
        "repro_torch.kernels.flash_attention, repro_torch.kernels.mamba, "
        "repro_torch.kernels.rwkv6, repro_torch.models.ssm, "
        "repro_torch.models, "
        "repro_torch.models.config, repro_torch.models.layers, "
        "repro_torch.models.transformer, repro_torch.models.model, "
        "repro_torch.configs, repro_torch.data.pipeline, "
        "repro_torch.serve, repro_torch.serve.engine, "
        "repro_torch.serve.service, repro_torch.engine.unified, "
        "repro_torch.engine.session_pool, repro_torch.engine.faults, "
        "repro_torch.launch, repro_torch.launch.mesh;"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro')]; print(bad); sys.exit(1 if bad else 0)")
    env = dict(os.environ,
               PYTHONPATH=os.pathsep.join([str(ROOT / "src"), str(ROOT)]))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def test_entry_points_without_device_raise_when_no_card(monkeypatch):
    """The default device is the card; with none the entry points raise
    rather than carry on on the CPU."""
    from repro_torch import engine
    from repro_torch.core import classifiers
    from repro_torch.core.protocols import baselines, kparty, one_way
    from repro_torch.core.protocols import two_way
    from repro_torch.configs import get_config
    from repro_torch.models import model
    from repro_torch.serve import ServeConfig, TokenServingEngine
    from repro_torch.serve import PoolConfig, ProtocolService
    from repro_torch.engine.session_pool import SessionPool
    from repro_torch.launch.mesh import make_data_mesh

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    shards = tdata.data1(n_per_node=20, k=2, seed=0)
    inst = [engine.ProtocolInstance(shards, 0.1)]
    mm = [engine.ProtocolInstance(shards, 0.1, "maxmarg")]
    ow = [engine.ProtocolInstance(shards, 0.1, sel)
          for sel in ("sampling", "naive")]
    X = np.concatenate([s[0] for s in shards])
    y = np.concatenate([s[1] for s in shards])
    lm_cfg = get_config("smollm-135m").reduced()
    lm = model.init_lm(lm_cfg, device="cpu")
    for call in (lambda: engine.run_sweep(inst),
                 lambda: engine.run_sweep(mm),
                 lambda: engine.run_instances(inst),
                 lambda: engine.maxmarg.run_instances(mm),
                 lambda: engine.pack_instances(inst, n_angles=8,
                                               max_epochs=2),
                 lambda: engine.pack_instances_maxmarg(mm, max_epochs=2,
                                                       max_support=4),
                 lambda: two_way.iterative_support_median(shards),
                 lambda: two_way.iterative_support_maxmarg(shards),
                 lambda: kparty.iterative_support_kparty(shards),
                 lambda: kparty.iterative_support_kparty(
                     shards, selector="maxmarg"),
                 lambda: classifiers.anneal_hard_margin(X, y),
                 lambda: classifiers.fit_max_margin(X, y),
                 lambda: tgeo.direction_grid(8),
                 lambda: engine.run_sweep(ow[:1]),
                 lambda: engine.oneway.run_instances(ow[1:2]),
                 lambda: one_way.random_sampling(shards, eps=0.1),
                 lambda: one_way.local_only(shards),
                 lambda: baselines.naive(shards),
                 lambda: baselines.voting(shards),
                 lambda: baselines.random(shards),
                 lambda: baselines.mixing(shards),
                 lambda: model.init_lm(lm_cfg),
                 lambda: model.from_reference({}, lm_cfg),
                 lambda: TokenServingEngine(lm_cfg, lm, ServeConfig(1, 8)),
                 lambda: engine.run_sweep(inst + mm, unified_dispatch=True),
                 lambda: engine.unified.run_instances(inst + mm),
                 lambda: engine.pack_instances_unified(
                     inst + mm, n_angles=8, max_epochs=2, max_support=4),
                 lambda: SessionPool(PoolConfig(slots=2, k=2, n_pad=16)),
                 lambda: ProtocolService(PoolConfig(slots=2, k=2, n_pad=16,
                                                    selector="unified")),
                 lambda: make_data_mesh(),
                 lambda: two_way.iterative_support_median_bit(shards),
                 lambda: two_way.iterative_support_noisy(shards)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
