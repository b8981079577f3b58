"""The port's dry run (`repro_torch.launch.{mesh,steps,op_analysis,dryrun,
report}`) against the reference's (`repro.launch.steps.lower_cell`,
`hlo_analysis`, compiled `memory_analysis`).

Both sides run in subprocesses, side by side: the reference needs 8 host
devices, which JAX fixes at its first use, and the port holds a fake
process group for the rest of its process's life.  (Never import
`repro.launch.dryrun` in a test process: it sets a 512-device XLA_FLAGS
when imported.)  Every reduced config runs a train, a prefill and a
decode cell of 4 x 64 tokens on a (2, 4) ("data", "model") mesh.

Per-device FLOPs agree within TOL, or the cell is one of GAPS, ROADMAP
queue C's list of the cells where they differ, pinned to its logged
ratio (port / reference) within TOL; a failure names the port's matmul
op whose per-device count is furthest from its count without a mesh
over the world size.  `arg_bytes` are equal up to the reference's scalar
arguments (the train step's number, the decode cache's write indices),
which the port keeps as Python ints.  A sharded matmul on a fake (16, 16)
mesh counts 1/256 of its FLOPs, and `test_hlo_analysis.py`'s two
programs (one matmul, ten in a loop) count what the reference's do.
"""
import json
import os
import subprocess
import sys

import pytest

ROOT = os.path.join(os.path.dirname(__file__), "..")
ARCHS = ["pixtral-12b", "gemma-7b", "starcoder2-15b", "deepseek-coder-33b", "qwen3-0.6b",
         "recurrentgemma-2b", "qwen2-moe-a2.7b", "moonshot-v1-16b-a3b", "mamba2-130m",
         "musicgen-large"]
KINDS = ["train", "prefill", "decode"]
TOL = 0.01
# (arch, kind): port / reference per-device FLOPs (ROADMAP queue C)
GAPS = {
    ("qwen3-0.6b", "train"): 0.9722, ("pixtral-12b", "train"): 0.9817,
    ("starcoder2-15b", "train"): 0.9818, ("deepseek-coder-33b", "train"): 0.9826,
    ("qwen2-moe-a2.7b", "train"): 1.1160, ("qwen2-moe-a2.7b", "prefill"): 1.2976,
    ("qwen2-moe-a2.7b", "decode"): 1.1213, ("moonshot-v1-16b-a3b", "train"): 1.1156,
    ("moonshot-v1-16b-a3b", "prefill"): 1.2939, ("moonshot-v1-16b-a3b", "decode"): 1.0783,
    ("mamba2-130m", "train"): 1.0334, ("mamba2-130m", "prefill"): 1.0427,
    ("recurrentgemma-2b", "train"): 1.0315, ("recurrentgemma-2b", "prefill"): 0.9650,
}

REFERENCE = r"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import importlib, json, sys
sys.path.insert(0, "src")
import jax, jax.numpy as jnp
from jax.sharding import AxisType, NamedSharding, PartitionSpec as P
from repro.configs.base import ShapeSpec
from repro.launch import steps
from repro.launch.hlo_analysis import analyze

# the reference's make_mesh defaults to explicit axes here, under which its
# embedding gather does not lower: its dry run's auto axes are asked for
mesh = jax.make_mesh((2, 4), ("data", "model"), axis_types=(AxisType.Auto,) * 2)
out = {}
for arch in sys.argv[1].split(","):
    cfg = importlib.import_module(
        "repro.configs." + arch.replace("-", "_").replace(".", "_")).reduced()
    for kind in ("train", "prefill", "decode"):
        shape = ShapeSpec(kind, 64, 4, kind)
        compiled = steps.lower_cell(cfg, shape, mesh, loss_chunk=32).compile()
        scalars = 4 if kind == "train" else 0
        if kind == "decode":
            cache = steps.shaped_cache(cfg, shape)
            scalars = sum(l.size * l.dtype.itemsize for p, l in
                          jax.tree_util.tree_leaves_with_path(cache)
                          if jax.tree_util.keystr(p).endswith("['index']"))
        out[arch + "/" + kind] = {"flops": analyze(compiled.as_text()).flops,
                                  "arg_bytes": compiled.memory_analysis().argument_size_in_bytes,
                                  "scalar_bytes": scalars}
A = jax.ShapeDtypeStruct((1024, 1024), jnp.float32,
                         sharding=NamedSharding(mesh, P("data", "model")))
B = jax.ShapeDtypeStruct((1024, 1024), jnp.float32, sharding=NamedSharding(mesh, P(None, "model")))

def f10(a, b):
    x, _ = jax.lax.scan(lambda x, _: (x @ b, ()), a, None, length=10)
    return x

out["matmul"] = analyze(jax.jit(lambda a, b: a @ b).lower(A, B).compile().as_text()).flops
out["matmul10"] = analyze(jax.jit(f10).lower(A, B).compile().as_text()).flops
print(json.dumps(out))
"""

PORT = r"""
import json, os, sys
sys.path.insert(0, "src")
import torch
from torch.distributed.tensor import distribute_tensor
from repro_torch.configs.base import ShapeSpec
from repro_torch.launch import dryrun, op_analysis, steps
from repro_torch.launch.mesh import fake_mesh, make_production_mesh, placements
from repro_torch.launch.train import reduced_config

torch.set_num_threads(1)
out = {}
mesh = fake_mesh((2, 4), ("data", "model"), "cpu")
for arch in sys.argv[1].split(","):
    cfg = reduced_config(arch)
    for kind in ("train", "prefill", "decode"):
        shape = ShapeSpec(kind, 64, 4, kind)
        cell = dryrun.count_cell(cfg, shape, mesh, loss_chunk=32)["costs"]
        whole = op_analysis.count(steps.lower_cell(cfg, shape, None, loss_chunk=32)[0])
        out[arch + "/" + kind] = {"flops": cell.flops, "arg_bytes": cell.arg_bytes,
                                  "by_op": cell.flops_by_op, "whole_by_op": whole.flops_by_op}

def program(m, a_spec, b_spec, loops):
    a = distribute_tensor(torch.empty(1024, 1024, device="meta"), m, placements(a_spec, m))
    b = distribute_tensor(torch.empty(1024, 1024, device="meta"), m, placements(b_spec, m))
    def run():
        x = a
        for _ in range(loops):
            x = x @ b
    return op_analysis.count(run)

for loops in (1, 10):
    c = program(mesh, ("data", "model"), (None, "model"), loops)
    out[f"matmul{loops if loops > 1 else ''}"] = c.flops
    out[f"bytes{loops}"] = [c.hbm_bytes, c.hbm_bytes_major, c.coll_bytes]

# a (256 x 4096) @ (4096 x 8192) matmul sharded on the (16, 16) production mesh
big = make_production_mesh(device="cpu")
a = distribute_tensor(torch.empty(256, 4096, device="meta"), big, placements(("data", None), big))
w = distribute_tensor(torch.empty(4096, 8192, device="meta"), big,
                      placements(("data", "model"), big))
out["production_matmul"] = op_analysis.count(lambda: a @ w).flops
out["production_world"] = big.size()
path = sys.argv[2]
dryrun.main(["--arch", "qwen3-0.6b", "--shape", "decode_32k", "--both-meshes", "--device", "cpu",
             "--out", path])
out["records"] = json.load(open(path))
print(json.dumps(out))
"""


def _spawn(script, *args):
    env = dict(os.environ, OMP_NUM_THREADS="1")
    return subprocess.Popen([sys.executable, "-c", script, *args], cwd=ROOT, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def _result(proc, what):
    out, err = proc.communicate(timeout=900)
    assert proc.returncode == 0, f"{what} side failed:\n{err[-4000:]}"
    return json.loads(out.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def sides(tmp_path_factory):
    records = tmp_path_factory.mktemp("dryrun") / "records.json"
    ref = _spawn(REFERENCE, ",".join(ARCHS))
    port = _spawn(PORT, ",".join(ARCHS), str(records))
    return _result(ref, "reference"), _result(port, "port")


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("arch", ARCHS)
def test_per_device_flops_match_the_reference(sides, arch, kind):
    ref, port = (s[f"{arch}/{kind}"] for s in sides)
    ratio = port["flops"] / ref["flops"]
    want = GAPS.get((arch, kind), 1.0)
    world = 8
    excess = {op: port["by_op"].get(op, 0.0) - f / world for op, f in port["whole_by_op"].items()}
    op = max(excess, key=lambda k: abs(excess[k]))
    assert abs(ratio / want - 1) <= TOL, (
        f"{arch} {kind}: port / reference FLOPs {ratio:.4f}, want {want} (queue C); the op "
        f"furthest from its unsharded count / {world} is {op}: {port['by_op'].get(op, 0.0):.0f} "
        f"against {port['whole_by_op'][op] / world:.0f}")
    # never less than a perfect split of the unsharded step's FLOPs
    assert port["flops"] >= sum(port["whole_by_op"].values()) / world * (1 - 1e-9)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("arch", ARCHS)
def test_arg_bytes_match_the_reference(sides, arch, kind):
    ref, port = (s[f"{arch}/{kind}"] for s in sides)
    assert port["arg_bytes"] == ref["arg_bytes"] - ref["scalar_bytes"]


def test_hlo_analysis_programs_count_what_the_reference_counts(sides):
    ref, port = sides
    assert port["matmul"] == ref["matmul"] == 2 * 512 * 1024 * 256
    assert port["matmul10"] == ref["matmul10"] == 10 * port["matmul"]
    hbm, major, coll = port["bytes10"]
    assert coll >= 10 * 512 * 1024 * 4        # the loop's all-gathers, counted 10 times
    assert 0 < major <= hbm


def test_sharded_matmul_counts_one_world_th(sides):
    port = sides[1]
    assert port["production_world"] == 256
    assert port["production_matmul"] == 2 * 256 * 4096 * 8192 / 256


def test_dryrun_records_at_published_width(sides):
    """qwen3-0.6b's decode_32k cell on both production meshes, as the
    reference's records: every field, useful work in (0, 1.05] and the
    same FLOPs x chips on the two meshes."""
    rec = sides[1]["records"]
    assert rec["failures"] == [] and len(rec["results"]) == 2
    one, two = rec["results"]
    assert (one["mesh"], one["chips"], two["mesh"], two["chips"]) == ("16x16", 256,
                                                                     "2x16x16", 512)
    for r in (one, two):
        for key in ("arch", "shape", "lower_s", "compile_s", "bytes_per_device", "temp_bytes",
                    "arg_bytes", "t_compute_s", "t_memory_s", "t_memory_major_s",
                    "t_collective_s", "bottleneck", "mfu_bound", "mfu_bound_major",
                    "flops_ratio", "coll_breakdown"):
            assert key in r
        assert 0 < r["flops_ratio"] <= 1.05 and r["arg_bytes"] > 0
    assert one["flops"] * 256 == pytest.approx(two["flops"] * 512, rel=1e-9)


def test_report_renders_the_reference_tables(sides):
    from repro_torch.launch import report
    rows = sides[1]["records"]["results"]
    for mesh in ("16x16", "2x16x16"):
        table = report.fmt_table(rows, mesh).splitlines()
        assert table[1] == f"### Mesh {mesh}"
        assert table[3].startswith("| arch | shape | Tc (s) |")
        assert len(table) == 6 and table[5].startswith("| qwen3-0.6b | decode_32k |")


def test_input_specs_match_the_reference():
    """Shapes and dtypes of every cell's inputs, as the reference's
    `input_specs` gives them (no mesh: batch placement is tested above
    through `arg_bytes`)."""
    import jax.numpy as jnp
    import numpy as np
    import torch
    from repro.configs import get as jget
    from repro.configs.base import SHAPES as JSHAPES
    from repro.launch.mesh import input_specs as jspecs
    from repro_torch.configs import SHAPES, get
    from repro_torch.launch.mesh import input_specs
    for arch in ARCHS:
        for name in SHAPES:
            want = jspecs(jget(arch), JSHAPES[name])
            got = input_specs(get(arch), SHAPES[name])
            assert set(got) == set(want)
            for k, t in got.items():
                assert tuple(t.shape) == want[k].shape and t.device.type == "meta"
                assert torch.empty((), dtype=t.dtype).numpy().dtype == np.dtype(
                    jnp.dtype(want[k].dtype))
