"""The port's planned collectives against the JAX package's compiled plan,
on the CPU.

Every architecture's reduced configuration is planned at every input shape
on the production (16, 16) mesh in both packages: JAX's
``lower_case(...).compile()`` on 256 forced host devices (in a
subprocess, as ``repro.launch.dryrun`` forces its placeholders), read by
``analyze_compiled``; the port's ``run_case`` on a fake process group of
256 ranks.  Wherever JAX compiles a case the port plans it, and every
decode step (decode_32k, long_500k) moves at most twice JAX's collective
bytes a device, plus 1 MB.  DeepSeek-V2's decode_32k is held so at full
size too (its faithful MLA reconstructs keys and values from the latent
cache, the case that moved 57.6 times JAX's bytes).  The figures are
byte counts of one step's plan, not times.  ``scripts/dryrun_compare.py``,
which holds the two packages' whole sweeps alike, is checked on small
records.
"""

import json
import os
import subprocess
import sys

import pytest
import torch.distributed as dist

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from repro_torch.configs import ARCHS, get_config  # noqa: E402
from repro_torch.launch import dryrun as TD  # noqa: E402
from repro_torch.models.config import INPUT_SHAPES  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DECODES = ("decode_32k", "long_500k")
SLACK = 1e6             # bytes: 2× JAX's + 1 MB

# JAX's side: compile the named cases on 256 host devices, one JSON line a
# case ({"arch", "shape", "status", "coll"}).  Importing the dry-run sets
# 512 placeholders; the flag is set to 256 before JAX's backend starts.
_JAX = r"""
import json, os, sys
from repro.launch import dryrun as JD
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=256"
import jax
from repro.analysis.roofline import analyze_compiled
from repro.configs import get_config
from repro.launch.mesh import make_production_mesh
from repro.models.config import INPUT_SHAPES
mesh = make_production_mesh()
for case in sys.argv[1:]:
    arch, name, size = case.split("/")
    cfg = get_config(arch) if size == "full" else get_config(arch).reduced()
    pol = JD.case_policy(cfg, INPUT_SHAPES[name])
    rec = {"arch": arch, "shape": name, "size": size}
    if pol.skip:
        rec["status"] = "skipped"
    else:
        try:
            with jax.set_mesh(mesh):
                low = JD.lower_case(cfg, INPUT_SHAPES[name], mesh, pol)
            rep = analyze_compiled(case, low.compile(), chips=256)
            rec.update(status="ok", coll=rep.collective_bytes)
        except Exception as e:  # noqa: BLE001 - reported to the test
            rec.update(status="error", error=f"{type(e).__name__}: {e}")
    print(json.dumps(rec), flush=True)
"""


class _JaxPlans:
    """JAX's compiled cases, each compiled once a process on demand."""

    def __init__(self):
        self.recs = {}

    def get(self, arch, shapes, size="reduced"):
        todo = [s for s in shapes if (arch, s, size) not in self.recs]
        if todo:
            env = dict(os.environ, JAX_PLATFORMS="cpu",
                       PYTHONPATH=os.path.join(ROOT, "src"))
            out = subprocess.run(
                [sys.executable, "-c", _JAX] + [f"{arch}/{s}/{size}"
                                                for s in todo],
                env=env, cwd=ROOT, capture_output=True, text=True,
                timeout=600)
            assert out.returncode == 0, out.stderr[-3000:]
            for line in out.stdout.splitlines():
                if line.startswith("{"):
                    r = json.loads(line)
                    self.recs[(r["arch"], r["shape"], r["size"])] = r
        return {s: self.recs[(arch, s, size)] for s in shapes}


@pytest.fixture(scope="module")
def jax_plans():
    return _JaxPlans()


def _coll(rec):
    return rec["roofline"]["collective_bytes"]


@pytest.mark.parametrize("arch", list(ARCHS))
def test_reduced_cases_plan_where_jax_compiles_and_hold_its_bytes(
        arch, jax_plans):
    """Each input shape of the reduced ``arch`` on the (16, 16) mesh: the
    port plans (status ok) wherever JAX compiles, skips where JAX skips,
    and each decode step's collective bytes a device are at most 2× JAX's
    + 1 MB.  No reduced case is left out."""
    cfg = get_config(arch).reduced()
    want = jax_plans.get(arch, list(INPUT_SHAPES))
    for name in INPUT_SHAPES:
        rec = TD.run_case(arch, name, "single", verbose=False, cfg=cfg)
        assert not dist.is_initialized()
        j = want[name]
        assert j["status"] != "error", (arch, name, j.get("error"))
        if j["status"] == "skipped":
            assert rec["status"] == "skipped", (arch, name)
            continue
        assert rec["status"] == "ok", (arch, name, rec.get("error"))
        if name in DECODES:
            got, ref = _coll(rec), j["coll"]
            assert got <= 2 * ref + SLACK, (
                f"{arch} {name}: the port moves {got:.4g} bytes a device, "
                f"JAX {ref:.4g}; top sites "
                f"{rec['roofline']['top_collectives'][:3]}")


def test_full_size_deepseek_v2_decode_holds_jax_bytes(jax_plans):
    """DeepSeek-V2 (236B) decode_32k at full size: the faithful MLA
    reconstructs each rank's own heads from the latent cache made whole on
    the model axis, so the plan moves at most 2× JAX's bytes (it moved
    57.6× before: the whole (B, 32k, H, 128) products all-reduced)."""
    arch, name = "deepseek-v2-236b", "decode_32k"
    j = jax_plans.get(arch, [name], "full")[name]
    assert j["status"] == "ok", j.get("error")
    rec = TD.run_case(arch, name, "single", verbose=False)
    assert rec["status"] == "ok", rec.get("error")
    assert _coll(rec) <= 2 * j["coll"] + SLACK, (
        _coll(rec), j["coll"], rec["roofline"]["top_collectives"][:3])


def test_dryrun_compare_flags_cases_over_twice_jax_or_risen(tmp_path):
    """``scripts/dryrun_compare.py`` flags a case whose port bytes exceed
    twice JAX's and JAX's + 0.05 GB, or (with ``--before``) rose by more
    than 5% from within twice JAX's; a small excess and a skip pass."""
    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    import dryrun_compare

    def rec(arch, coll, status="ok"):
        r = {"arch": arch, "shape": "decode_32k", "mesh": "single",
             "status": status}
        if status == "ok":
            r["roofline"] = {"collective_bytes": coll, "arg_bytes": 1e9,
                             "temp_bytes": 2e9}
        return r

    def write(name, recs):
        path = tmp_path / name
        path.write_text("".join(json.dumps(r) + "\n" for r in recs))
        return str(path)

    jax = write("jax", [rec("a", 1e9), rec("b", 1e6), rec("c", 1e9),
                        rec("d", 0, "skipped")])
    ok = write("ok", [rec("a", 1.9e9), rec("b", 4e7), rec("c", 1e9),
                      rec("d", 0, "skipped")])
    assert dryrun_compare.main([jax, ok]) == 0
    over = write("over", [rec("a", 2.1e9), rec("b", 4e7), rec("c", 1e9),
                          rec("d", 0, "skipped")])
    assert dryrun_compare.main([jax, over]) == 1
    before = write("before", [rec("a", 1.9e9), rec("b", 4e7),
                              rec("c", 0.9e9), rec("d", 0, "skipped")])
    assert dryrun_compare.main([jax, ok, "--before", before]) == 1
    assert dryrun_compare.main([jax, before, "--before", ok]) == 0
