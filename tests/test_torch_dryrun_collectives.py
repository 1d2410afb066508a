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
    than 5% from within twice JAX's; a small excess and a skip pass.
    Alike for FLOPs a device (over 1.5× JAX's + 1e12; over 1.25× only
    marked) and the peak (over 2× JAX's + 1 GB, or over 80 GB)."""
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

    def work(arch, flops, peak_gb, status="ok"):
        r = rec(arch, 1e9, status)
        if status == "ok":
            r["roofline"].update(flops=flops, arg_bytes=1e9,
                                 temp_bytes=peak_gb * 1e9 - 1e9)
        return r

    jax = write("jax_w", [work("a", 1e13, 3), work("b", 1e14, 50),
                          work("c", 0, 0, "skipped")])
    fine = write("fine_w", [work("a", 1.4e13, 6.9), work("b", 1.2e14, 79),
                            work("c", 0, 0, "skipped")])
    assert dryrun_compare.main([jax, fine]) == 0
    for bad in ([work("a", 1.7e13, 3), work("b", 1e14, 50)],
                [work("a", 1e13, 7.5), work("b", 1e14, 50)],
                [work("a", 1e13, 3), work("b", 1e14, 81)],
                [work("a", 1e13, 3)]):
        assert dryrun_compare.main([jax, write("bad_w", bad)]) == 1, bad
    low = write("low_w", [work("a", 1.0e13, 3), work("b", 1e14, 50)])
    assert dryrun_compare.main([jax, fine, "--before", low]) == 1
    assert dryrun_compare.main([jax, low, "--before", fine]) == 0
    rose = write("rose_w", [work("a", 1.0e13, 3.3), work("b", 1e14, 50)])
    assert dryrun_compare.main([jax, rose, "--before", low]) == 1


@pytest.mark.parametrize("alltoall", [True, False])
def test_split_moved_between_dims_is_planned_as_its_group_runs_it(alltoall):
    """A split moved from one dim to another on a model axis of 4 is one
    all-to-all where the group does all-to-all (NCCL, gloo on CUDA:
    ``PlanMode(alltoall=True)``), planned at the wire bytes a real run's
    ``CommTally`` counts for DTensor's operator on the same local block
    (3/4 of it); on the CPU's route (``alltoall=False``) it is an
    all-gather and a slice, 4 times those bytes."""
    import torch
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.analysis.roofline import CommTally, PlanMode
    from repro_torch.launch.mesh import _mesh

    TD.fake_group(4)
    try:
        mesh = _mesh("cpu", (1, 4), ("data", "model"))
        mode = PlanMode(alltoall=alltoall)
        with mode:
            x = distribute_tensor(torch.empty(8, 16, 32), mesh,
                                  [Replicate(), Shard(0)])
            mode.start()
            y = x.redistribute(mesh, [Replicate(), Shard(1)])
            assert tuple(y.to_local().shape) == (8, 4, 32)
        block = 2 * 16 * 32 * 4            # a rank's (2, 16, 32) f32 block
        with CommTally() as tally:
            torch.ops._dtensor.shard_dim_alltoall(
                torch.zeros(2, 16, 32), 0, 1,
                mesh.get_group(1).group_name)
    finally:
        dist.destroy_process_group()
    assert dict(tally.bytes) == {"all-to-all": block * 3 / 4}
    assert dict(tally.counts) == {"all-to-all": 1}
    if alltoall:
        assert dict(mode.coll_bytes) == dict(tally.bytes)
        assert dict(mode.coll_counts) == dict(tally.counts)
    else:
        assert dict(mode.coll_bytes) == {"all-gather": 4 * block * 3 / 4}
        assert dict(mode.coll_counts) == {"all-gather": 1}
