"""The comparison that decides ``correct``: the plain reference agrees
with the program at small sizes on the host, and the comparison fails the
control (the reference in bfloat16 put in the program's place) and every
fault the sweep cells can have, planted underneath the timed path."""

import pytest

from portbench import control, harness
from portbench.tests import _small

CELLS = ["grid-median-b12288", "grid-maxmarg-b4608"]


def _run(cell, fault=None):
    return harness.execute(cell, _small.SEED, 0.2, False, device="cpu",
                           traffic_override=_small.TRAFFIC,
                           config_override=_small.CONFIG, fault=fault)


@pytest.mark.parametrize("cell", CELLS)
def test_program_agrees_with_the_reference(cell):
    out = _run(cell)
    assert out["correct"], out["checks"]
    assert list(out)[-1] == "checks"
    assert out["attempted"] > 0 and out["failed"] == 0


@pytest.mark.parametrize("cell", CELLS)
def test_control_in_bfloat16_is_not_correct(cell):
    limits = harness.resolve(cell)[4]["limits"]
    r = control.readings(cell, _small.SEED, "cpu",
                         traffic_override={"seeds": 8},
                         config_override=_small.CONFIG)
    assert all(r["program"][k] <= v for k, v in limits.items()
               if k in r["program"]), r
    assert any(r["control"][k] > v for k, v in limits.items()
               if k in r["control"]), r


def _selector(cell):
    return "median" if "median" in cell else "maxmarg"


def _step_unchanged(cell):
    def fault(run, state):
        from repro_torch.engine import maxmarg, median
        mod = median if _selector(cell) == "median" else maxmarg
        patch.setattr(mod, "step", lambda data, *a, **kw: a[-1]
                      if _selector(cell) == "median" else a[0])
    return fault


def _half_left_out(cell):
    def fault(run, state):
        from repro_torch import engine
        real = engine.run_sweep

        def half(instances, **kw):
            n = len(instances)
            res = real(instances[:n // 2], **kw)
            return res + res[:n - n // 2]
        patch.setattr(engine, "run_sweep", half)
    return fault


def _answer_altered(cell):
    def fault(run, state):
        from repro_torch.engine import maxmarg, median
        mod = median if _selector(cell) == "median" else maxmarg
        real = mod.step

        def step(*a, **kw):
            new = real(*a, **kw)
            return new._replace(comm=new.comm._replace(
                points=new.comm.points + 1))
        patch.setattr(mod, "step", step)
    return fault


patch = None


@pytest.mark.parametrize("make", [_step_unchanged, _half_left_out,
                                  _answer_altered],
                         ids=["step-unchanged", "half-left-out",
                              "answer-altered"])
@pytest.mark.parametrize("cell", CELLS)
def test_each_fault_is_not_correct(cell, make, monkeypatch):
    global patch
    patch = monkeypatch
    out = _run(cell, fault=make(cell))
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("exact,gap", [(True, 1.0), (False, 0.0)],
                         ids=["exact", "within-rounding"])
def test_an_unconverged_separator_counts_where_the_comparison_is_exact(
        exact, gap):
    import numpy as np

    from portbench.generators import sweep
    want = ([5, 3, 0, 4, 2], 8, False, np.array([1.0, 0.0, 0.0]))
    got = ([5, 3, 0, 4, 2], 8, False, np.array([0.0, 1.0, 0.0]))
    n = sweep.numbers([got], [want], exact)
    assert n["decisions_differing"] == 0
    assert n["separator_gap"] == pytest.approx(gap * np.sqrt(2.0))
    assert n["direction_gap"] == pytest.approx(gap * np.sqrt(2.0))


def test_the_direction_gap_leaves_out_the_scale_alone():
    import numpy as np

    from portbench.generators import sweep
    want = ([10, 0, 2, 6, 2], 1, True, np.array([-5.0, 11.0, -4.5]))
    scaled = ([10, 0, 2, 6, 2], 1, True, 1.14 * want[3])
    n = sweep.numbers([scaled], [want], False)
    assert n["separator_gap"] == pytest.approx(0.14)
    assert n["direction_gap"] == pytest.approx(0.0, abs=1e-12)
    turned = ([10, 0, 2, 6, 2], 1, True, np.array([-5.0, 11.0, -3.5]))
    n = sweep.numbers([turned], [want], False)
    assert n["direction_gap"] > 0.05


@pytest.mark.card
def test_the_graphed_reference_stage_equals_its_steps(card):
    import torch

    from portbench.reference import maxmarg
    g = torch.Generator(device=card).manual_seed(_small.SEED)
    X = torch.randn((16, 70, 2), generator=g, device=card)
    yi = torch.where(X[..., 0] + 0.3 * X[..., 1] > 0, 1, -1).to(torch.int32)
    yi[:, -5:] = 0
    yf, valid = yi.float(), yi != 0
    nv = valid.sum(dim=1).float()
    starts = [(torch.zeros((16, 2), device=card),
               torch.zeros((16,), device=card)),
              (torch.randn((16, 2), generator=g, device=card),
               torch.randn((16,), generator=g, device=card))]
    for lam in maxmarg.lam_schedule(1e-3, 2, torch.float32):
        for w0, b0 in starts:       # the second replays the first's graph
            want = maxmarg._steps(X, yf, valid, nv, w0, b0, lam, 300, 0.0)
            got = maxmarg._stage(X, yf, valid, nv, w0, b0, lam, 300)
            assert all(torch.equal(a, b) for a, b in zip(got, want))
