"""The harness finds every part of a cell by name, and BENCHMARK.json
keeps to the shape its readers expect."""

import json
import re

import pytest

from portbench import harness

BENCH = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
CELLS = [c["name"] for c in BENCH["workloads"]]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51


@pytest.mark.parametrize("cell", CELLS)
def test_cell_parts_are_found_by_name(cell):
    bench, entry, config, traffic, limits = harness.resolve(cell)
    assert (harness.HERE / "generators"
            / f"{traffic['generator']}.py").exists()
    assert limits["limits"]
    assert config["reduced"] == next(
        c["reduced"] for c in bench["configs"] if c["name"] == entry["config"])
    for kind in ("end_to_end", "per_layer"):
        metrics = harness.cell_metrics(bench, entry, kind)
        assert metrics, (cell, kind)
        for m in metrics:
            reader = harness.load_module(
                harness.HERE / "metrics" / f"{m['name']}.py", "r")
            assert callable(reader.read)


def test_names_units_and_bounds():
    names = [m["name"] for k in ("end_to_end", "per_layer") for m in BENCH[k]]
    names += CELLS + [c["name"] for c in BENCH["configs"]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        assert set(m.get("workloads", CELLS)) <= set(CELLS)


def test_every_cell_reports_setup_another_metric_and_a_layer():
    for entry in BENCH["workloads"]:
        e2e = [m["name"] for m in harness.cell_metrics(BENCH, entry,
                                                       "end_to_end")]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert harness.cell_metrics(BENCH, entry, "per_layer")
