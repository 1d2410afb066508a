"""The port's planned work and peak a device against the JAX package's
compiled plan, on the CPU.

Each case keeps one production case's head counts, policy (the full-size
configuration's: FSDP, microbatches, remat) and batch to rank ratio on the
(16, 16) mesh, at reduced depth and width: the query heads that the model
axis divides but the key heads do not (64 / 8, qwen1.5-110b prefill), the
query heads it does not divide (40 / 8, qwen2.5-14b prefill; 9 / 3,
smollm-135m prefill, whose batch of 32 is below the 256 ranks, so its
pure data-parallel policy falls back to the model axis in both packages)
and deepseek-7b's training step (32 / 32, remat, four microbatches; wide
enough that gathering its row-parallel weights in the backward pass, as
DTensor did where the gradient came back as partial sums, shows).  JAX
compiles each on 256 forced host devices in a subprocess (as
``repro.launch.dryrun`` forces its placeholders), read by
``analyze_compiled``; the port plans each on a fake process group of 256
ranks.  The port's FLOPs a device are at most 1.5× JAX's and its peak
(arguments and temporaries) at most 2× JAX's plus 1 GB.  The figures are
FLOP and byte counts of one step's plan, not times.
"""

import dataclasses
import json
import os
import subprocess
import sys

import pytest
import torch.distributed as dist

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import dryrun as TD  # noqa: E402
from repro_torch.models.config import INPUT_SHAPES  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GB = 1e9

# (arch, shape, overrides of the reduced configuration)
CASES = [
    ("qwen1.5-110b", "prefill_32k", {"n_heads": 64, "n_kv": 8,
                                     "n_layers": 1}),
    ("qwen2.5-14b", "prefill_32k", {"n_heads": 40, "n_kv": 8,
                                    "n_layers": 1}),
    ("smollm-135m", "prefill_32k", {"n_heads": 9, "n_kv": 3,
                                    "n_layers": 2}),
    ("deepseek-7b", "train_4k", {"n_heads": 32, "n_kv": 32,
                                 "n_layers": 2, "d_model": 1024,
                                 "d_ff": 4096}),
]

# JAX's side: each named case compiled on 256 host devices under the full
# configuration's policy, one JSON line a case ({"case", "status", "flops",
# "peak"}).  Importing the dry-run sets 512 placeholders; the flag is set
# to 256 before JAX's backend starts.
_JAX = r"""
import dataclasses, json, os, sys
from repro.launch import dryrun as JD
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=256"
import jax
from repro.analysis.roofline import analyze_compiled
from repro.configs import get_config
from repro.launch.mesh import make_production_mesh
from repro.models.config import INPUT_SHAPES
mesh = make_production_mesh()
for case in json.loads(sys.argv[1]):
    arch, name, over = case
    shape = INPUT_SHAPES[name]
    cfg = dataclasses.replace(get_config(arch).reduced(), **over)
    pol = JD.case_policy(get_config(arch), shape)
    rec = {"case": f"{arch}/{name}"}
    try:
        with jax.set_mesh(mesh):
            low = JD.lower_case(cfg, shape, mesh, pol)
        rep = analyze_compiled(rec["case"], low.compile(), chips=256)
        rec.update(status="ok", flops=rep.flops,
                   peak=rep.arg_bytes + rep.temp_bytes)
    except Exception as e:  # noqa: BLE001 - reported to the test
        rec.update(status="error", error=f"{type(e).__name__}: {e}")
    print(json.dumps(rec), flush=True)
"""


@pytest.fixture(scope="module")
def jax_plans():
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run([sys.executable, "-c", _JAX, json.dumps(CASES)],
                         env=env, cwd=ROOT, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    recs = [json.loads(line) for line in out.stdout.splitlines()
            if line.startswith("{")]
    return {r["case"]: r for r in recs}


def _port_plan(arch, name, over):
    """The port's plan of the case, under the full configuration's
    policy."""
    shape = INPUT_SHAPES[name]
    cfg = dataclasses.replace(get_config(arch).reduced(), **over)
    pol = dataclasses.asdict(TD.case_policy(get_config(arch), shape))
    rec = TD.run_case(arch, name, "single", overrides=pol, verbose=False,
                      cfg=cfg)
    assert not dist.is_initialized()
    assert rec["status"] == "ok", (arch, name, rec.get("error"))
    return rec["roofline"]


@pytest.mark.parametrize("arch,name,over", CASES,
                         ids=[f"{a}-{n}" for a, n, _ in CASES])
def test_flops_and_peak_a_device_hold_jax_plan(arch, name, over,
                                               jax_plans):
    """FLOPs a device at most 1.5× JAX's, the peak at most 2× JAX's + 1 GB;
    the sites named on failure (``top_flops``, ``top_live``)."""
    j = jax_plans[f"{arch}/{name}"]
    assert j["status"] == "ok", j.get("error")
    r = _port_plan(arch, name, over)
    assert r["flops"] <= 1.5 * j["flops"], (
        f"{arch} {name}: {r['flops']:.4g} FLOPs a device, JAX "
        f"{j['flops']:.4g}; top sites {r['top_flops'][:4]}")
    peak = r["arg_bytes"] + r["temp_bytes"]
    assert peak <= 2 * j["peak"] + GB, (
        f"{arch} {name}: peak {peak / GB:.3f} GB, JAX {j['peak'] / GB:.3f};"
        f" live at the peak {r['top_live'][:4]}")


def test_plan_records_name_their_flops_and_peak_sites():
    """Every record carries ``top_flops`` (FLOPs by ``repro_torch`` call
    site, backward operations under their forward site) and ``top_live``
    (the bytes alive at the peak by the site that made them): the
    attention's products lead a prefill's FLOPs, and the sums of the
    sites are the totals."""
    arch, name, over = CASES[1]
    r = _port_plan(arch, name, over)
    sites = [row["site"] for row in r["top_flops"]]
    assert all(s.startswith("repro_torch.") for s in sites), sites
    assert any("models.layers" in s for s in sites[:3]), sites
    assert sum(row["flops"] for row in r["top_flops"]) <= r["flops"] * (
        1 + 1e-12)
    assert r["top_live"] and sum(row["bytes"] for row in r["top_live"]) \
        <= r["temp_bytes"]
    train = _port_plan(*CASES[3])
    assert any(row["site"].endswith("(backward)")
               for row in train["top_flops"]), train["top_flops"]


@pytest.mark.parametrize("H,KV,m,Sq,want", [
    (40, 8, 16, 32768, (8, 2)),     # qwen2.5-14b: one key head's group a
    (12, 2, 16, 32768, (4, 4)),     # block, as JAX's HLO shows; qwen2-vl:
    (9, 3, 16, 32768, (1, 16)),     # 3 of a group's 6; smollm: every head
    (9, 3, 2, 512, (1, 2)),         # chip_smoke 21d's (1, 2)
    (64, 8, 16, 32768, None),       # the query heads split: _mesh_core
    (9, 3, 16, 1, None),            # a decode step's one row
    (40, 8, 16, 3000, None),        # rows that do not take the block pass
    (9, 3, 0, 32768, None),         # no model axis
])
def test_head_blocks_follow_jax_layouts(H, KV, m, Sq, want):
    """``layers.head_blocks`` groups the query heads by key head as GSPMD
    splits them (the layouts ``scripts/jax_dot_layouts.py`` reads from
    JAX's compiled plans) and splits each block's rows over the ranks
    GSPMD leaves computing the same block."""
    from repro_torch.models.layers import head_blocks
    got = head_blocks(H, KV, m, Sq, 1024)
    assert got == want
    if got:
        blocks, r = got
        assert blocks * r == m and H % blocks == 0
