"""The frozen copies equal the program's originals today, and the metric
arithmetic does what its name says."""

import json

import numpy as np
import pytest
import torch

from portbench.yardstick import bounds, datasets, stats, trace
from repro_torch.analysis import bounds as live_bounds
from repro_torch.core import datasets as live_datasets


@pytest.mark.parametrize("B,m,n", [(1, 8, 16), (5, 1024, 1000), (3, 64, 7)])
def test_cut_work_equals_the_programs(B, m, n):
    g = torch.Generator().manual_seed(B * m + n)
    V = torch.rand((m, 2), generator=g)
    dir_ok = torch.rand((B, m), generator=g) > 0.3
    lo, hi = torch.rand((B, m), generator=g), torch.rand((B, m), generator=g)
    X = torch.rand((B, n, 2), generator=g)
    y = torch.randint(-1, 2, (B, n), generator=g, dtype=torch.int32)
    assert bounds.cut_work(V, dir_ok, lo, hi, X, y) == \
        live_bounds.cut_work(V, dir_ok, lo, hi, X, y)


@pytest.mark.parametrize("B,N,d,nsteps", [(4, 100, 2, 2000), (9, 1056, 2, 500),
                                          (2, 33, 16, 7)])
def test_pegasos_and_turn_work_equal_the_programs(B, N, d, nsteps):
    g = torch.Generator().manual_seed(N + d)
    X = torch.rand((B, N, d), generator=g)
    y = torch.randint(-1, 2, (B, N), generator=g).float()
    args = (X, y, torch.ones(B), torch.zeros(B, d), torch.zeros(B),
            torch.ones(B), torch.zeros(B, dtype=torch.bool),
            torch.zeros(B, d), torch.zeros(B))
    assert bounds.pegasos_work(*args, nsteps=nsteps) == \
        live_bounds.pegasos_work(*args, nsteps=nsteps)
    Xk = torch.rand((B, 2, N, d), generator=g)
    yk = torch.randint(-1, 2, (B, 2, N), generator=g, dtype=torch.int32)
    targs = (X[:, 0], X[:, 0, 0], X, y.int(), Xk, yk)
    assert bounds.turn_work(*targs) == live_bounds.turn_work(*targs)
    for work in (bounds.Work(10 ** 9, 10 ** 12), bounds.Work(10, 10 ** 9, 5)):
        assert bounds.bound_ms(work) == live_bounds.bound_ms(
            live_bounds.Work(*work))


def test_extremes_work_equals_the_programs():
    g = torch.Generator().manual_seed(3)
    v = torch.rand((6, 2), generator=g)
    X = torch.rand((6, 2, 50, 2), generator=g)
    y = torch.randint(-1, 2, (6, 2, 50), generator=g, dtype=torch.int32)
    wx = torch.rand((6, 2, 40, 2), generator=g)
    wy = torch.randint(-1, 2, (6, 2, 40), generator=g, dtype=torch.int32)
    assert bounds.extremes_work(v, X, y, wx, wy, 24) == \
        live_bounds.extremes_work(v, X, y, wx, wy, 24)
    assert bounds.PEAK_F32 == live_bounds.PEAK_F32
    assert bounds.HBM_BW == live_bounds.HBM_BW
    assert bounds.PEAK_FLOPS_BF16 == live_bounds.PEAK_FLOPS_BF16


@pytest.mark.parametrize("name", ["data1", "data2", "data3"])
@pytest.mark.parametrize("seed", [0, 7, 2 ** 31 + 5])
def test_data_sets_equal_the_programs(name, seed):
    ours = datasets.GENERATORS[name](n_per_node=40, k=2, seed=seed)
    theirs = getattr(live_datasets, name)(n_per_node=40, k=2, seed=seed)
    noisy = datasets.add_label_noise(ours, 0.1, seed=seed + 1)
    live_noisy = live_datasets.add_label_noise(theirs, 0.1, seed=seed + 1)
    for (X, y), (Xt, yt) in zip(noisy, live_noisy):
        np.testing.assert_array_equal(X, Xt)
        np.testing.assert_array_equal(y, yt)


def test_rate_is_all_work_over_all_time():
    assert stats.rate(12288 * 7, 9.5) == pytest.approx(9054.3157894)
    with pytest.raises(ValueError):
        stats.rate(1, 0)


def test_union_and_gaps_of_intervals():
    iv = [(0, 2), (1, 3), (5, 6), (5.5, 5.7), (8, 12)]
    assert stats.union_length(iv, 0, 10) == 3 + 1 + 2
    assert stats.gaps(iv, 0, 10) == [(3, 5), (6, 8)]
    assert stats.union_length([], 0, 1) == 0


def _chrome(tmp_path, events):
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": events}))
    return str(path)


def test_trace_idle_share_and_gap_names(tmp_path):
    def ev(cat, name, ts, dur, tid=1):
        return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
                "pid": 1, "tid": tid}
    events = [
        ev("user_annotation", trace.WINDOW_SPAN, 0, 100),
        ev("user_annotation", "layer.pack", 0, 40),
        ev("cpu_op", "aten::copy_", 30, 10),
        ev("user_annotation", "layer.hotloop", 40, 60),
        ev("cpu_op", "aten::add", 60, 5, tid=9),       # another thread
        ev("kernel", "cut_scan(float2 const*)", 40, 10, tid=7),
        ev("kernel", "cut_scan(float2 const*)", 45, 10, tid=7),
        ev("gpu_memcpy", "Memcpy HtoD", 80, 10, tid=7),
        ev("kernel", "outside", 150, 10, tid=7),
    ]
    t = trace.load(_chrome(tmp_path, events))
    assert t.window_s == pytest.approx(100e-6)
    assert t.busy_s == pytest.approx(25e-6)
    assert t.kernel_count() == 2
    assert t.kernel_seconds("cut_scan") == pytest.approx(20e-6)
    gaps = dict(t.idle_gaps())
    assert gaps["layer.pack"] == pytest.approx(40e-6)
    assert gaps["layer.hotloop"] == pytest.approx(35e-6)
    assert "aten::add" not in gaps
    assert t.top_device_ops()[0][0] == "cut_scan(float2 const*)"


def test_host_readings_name_the_probe_and_the_cpu_share():
    from portbench.yardstick import host
    a = host.snapshot()
    b = host.snapshot()
    line = host.between(a, b)
    assert line.startswith("host probe_ms ")
    assert a["probe_ms"] > 0 and "cpu_pct" in line
