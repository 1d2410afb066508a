"""Nothing the benchmark runs imports JAX or the JAX package (top-level
module names compared whole, so ``repro_torch`` passes), and the command
refuses to measure without a card."""

import ast
import functools
import json
import os
import shutil
import subprocess
import sys
import types

import pytest

from portbench import harness
from portbench.tests import _small

SOURCES = sorted(harness.HERE.rglob("*.py"))


def _top(name):
    return name.split(".")[0]


@pytest.mark.parametrize("path", SOURCES,
                         ids=lambda p: str(p.relative_to(harness.ROOT)))
def test_no_source_imports_jax_or_the_jax_package(path):
    tree = ast.parse(path.read_text(encoding="utf-8"))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        assert not any(_top(n) in harness.FOREIGN for n in names), names


def test_top_level_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torch_like", sys)
    assert "repro_torch_like" not in harness.foreign_modules()
    monkeypatch.setitem(sys.modules, "repro.core", sys)
    assert harness.foreign_modules() == ["repro.core"]


def test_a_run_loads_neither_jax_nor_the_jax_package():
    code = (
        "import sys, json\n"
        f"sys.path[:0] = [{str(harness.ROOT)!r}, "
        f"{str(harness.ROOT / 'src')!r}]\n"
        "from portbench import harness\n"
        "from portbench.tests import _small\n"
        "harness.execute('grid-median-b12288', 5, 0.1, False, "
        "device='cpu', traffic_override={'seeds': 1}, "
        "config_override=_small.CONFIG)\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=harness.ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    tops = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "repro_torch" in tops
    assert not tops & set(harness.FOREIGN)


def _run_py(cwd, env=None):
    return subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         "grid-median-b12288", "--seed", "3", "--seconds", "1", "--trace",
         "0"], capture_output=True, text=True, timeout=300, cwd=cwd, env=env)


def test_without_a_card_the_command_fails_and_prints_no_result():
    import torch
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    if torch.cuda.is_available():
        pytest.skip("a card is visible to this process's children")
    out = _run_py(harness.ROOT, env)
    assert out.returncode != 0
    assert "{" not in out.stdout


def test_beside_nothing_but_itself_the_command_fails(tmp_path):
    shutil.copy(harness.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(harness.HERE, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _run_py(tmp_path)
    assert out.returncode != 0
    assert "{" not in out.stdout


@pytest.mark.card
def test_a_short_run_on_the_card_is_correct(card):
    out = _run_py(harness.ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["platform"] == "gpu"
    assert _small.SEED > 2 ** 31


def _plant_in_reference(monkeypatch):
    from portbench.reference import median
    real = median.run

    def run(*a, **kw):
        monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
        return real(*a, **kw)
    monkeypatch.setattr(median, "run", run)


def _plant_in_metric_reader(monkeypatch):
    real = harness.load_module

    def load(path, name):
        mod = real(path, name)
        if name.startswith("portbench_metric_"):
            monkeypatch.setitem(sys.modules, "repro", types.ModuleType(
                "repro"))
        return mod
    monkeypatch.setattr(harness, "load_module", load)


@pytest.mark.parametrize("plant", [_plant_in_reference,
                                   _plant_in_metric_reader],
                         ids=["reference", "metric-reader"])
def test_a_foreign_module_loaded_after_the_window_refuses_the_run(
        plant, monkeypatch):
    import torch

    from portbench import run as run_py

    plant(monkeypatch)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch, "set_num_threads", lambda n: None)
    monkeypatch.setattr(run_py, "_environment", lambda: None)
    real = harness.execute
    monkeypatch.setattr(harness, "execute", functools.partial(
        real, device="cpu", traffic_override=_small.TRAFFIC,
        config_override=_small.CONFIG))
    with pytest.raises(harness.ForeignImport):
        harness.execute("grid-median-b12288", _small.SEED, 0.1, False)
    assert run_py.main(["--workload", "grid-median-b12288", "--seed",
                        str(_small.SEED), "--seconds", "0.1", "--trace",
                        "0"]) == 3
