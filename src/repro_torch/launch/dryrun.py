"""The multi-pod dry run: every (architecture x input shape x mesh) cell
of the LM stack at its published widths, as per-device roofline terms.
The port of `repro.launch.dryrun`.

    python -m repro_torch.launch.dryrun --arch gemma-7b --shape train_4k
    python -m repro_torch.launch.dryrun --all --both-meshes --out build/dryrun_results.json

The reference lowers and compiles each cell for 256 or 512 placeholder
devices and reads its compiled HLO.  The port builds each cell's state as
meta shards of DTensors on a fake process group of that many ranks
(`launch.mesh.make_production_mesh`), runs the step once, and counts the
ops rank 0 runs (`launch.op_analysis`): no memory is allocated and no
byte is moved, so every number is analytic, a count, not a measurement.
The roofline terms are `launch.roofline`'s, at the card's data-sheet
peaks: FLOPs at the bf16 tensor-core rate, bytes at the memory rate, and
collective bytes at NVLink's 450 GB/s each way.  A (16, 16) mesh of H100s
spans 32 hosts of 8 cards, so off the host that term is a lower bound.

The fake tensors' mesh is on the card's device type unless `--device
cpu` is given (the CPU tests give it).  The process holds the fake group
for the rest of its life: run the dry run in a process of its own.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
import traceback

import torch

from repro_torch.configs import ARCH_IDS, SHAPES, applicable_shapes, get
from repro_torch.launch import op_analysis, roofline as rl, steps
from repro_torch.launch.mesh import make_production_mesh


def peaks_for(device) -> rl.Peaks:
    """The visible card's data-sheet peaks, or the H100 SXM's for the CPU."""
    if device is not None and torch.device(device).type == "cpu":
        return rl.H100_SXM
    return rl.card_peaks(torch.cuda.get_device_name(0))


def _count_once(cfg, shape, mesh, loss_chunk: int) -> dict:
    """Lay the cell out and count its step's second run: DTensor's first
    dispatch of a layout runs local ops of its own (chunks and copies by
    the thousand) that a step does not repeat."""
    t0 = time.time()
    run, args = steps.lower_cell(cfg, shape, mesh, loss_chunk=loss_chunk)
    run()
    t1 = time.time()
    costs = op_analysis.count(run, args)
    return {"costs": costs, "lower_s": t1 - t0, "run_s": time.time() - t1}


def _extrapolate(a: op_analysis.OpCosts, b: op_analysis.OpCosts, n: int) -> op_analysis.OpCosts:
    """a + n (b - a), field by field: the costs of a model with n more
    layer periods than a's, b having one more."""
    def ext(x, y):
        return x + n * (y - x)
    return op_analysis.OpCosts(
        flops=ext(a.flops, b.flops), hbm_bytes=ext(a.hbm_bytes, b.hbm_bytes),
        hbm_bytes_major=ext(a.hbm_bytes_major, b.hbm_bytes_major),
        coll_bytes=ext(a.coll_bytes, b.coll_bytes),
        coll_breakdown={k: ext(a.coll_breakdown.get(k, 0.0), b.coll_breakdown.get(k, 0.0))
                        for k in set(a.coll_breakdown) | set(b.coll_breakdown)},
        peak_bytes=ext(a.peak_bytes, b.peak_bytes), arg_bytes=ext(a.arg_bytes, b.arg_bytes),
        flops_by_op={k: ext(a.flops_by_op.get(k, 0.0), b.flops_by_op.get(k, 0.0))
                     for k in set(a.flops_by_op) | set(b.flops_by_op)},
        ops=ext(a.ops, b.ops))


def count_cell(cfg, shape, mesh, *, loss_chunk: int = 512) -> dict:
    """Run one cell's step on `mesh` and count it: the costs (with the
    argument bytes the step reads and the peak bytes its ops hold), and
    the seconds taken to lay the state out (with the warm-up run) and to
    run the counted step.

    Every period of the layer pattern is the same program, as the
    reference's scan over blocks is, whose body its analyzer weights by
    the trip count: so a model of more than two periods is counted at one
    and at two periods (with the tail layers), and the difference, one
    period's costs, is added for each further period."""
    period = len(cfg.layer_pattern)
    periods, tail = divmod(cfg.num_layers, period)
    if periods <= 2:
        return _count_once(cfg, shape, mesh, loss_chunk)
    one = _count_once(dataclasses.replace(cfg, num_layers=period + tail), shape, mesh,
                      loss_chunk)
    two = _count_once(dataclasses.replace(cfg, num_layers=2 * period + tail), shape, mesh,
                      loss_chunk)
    return {"costs": _extrapolate(one["costs"], two["costs"], periods - 1),
            "lower_s": one["lower_s"] + two["lower_s"], "run_s": one["run_s"] + two["run_s"]}


def run_cell(arch: str, shape_name: str, *, multi_pod: bool = False,
             verbose: bool = True, loss_chunk: int = 512, device=None) -> dict:
    cfg = get(arch)
    shape = SHAPES[shape_name]
    mesh = make_production_mesh(multi_pod=multi_pod, device=device)
    chips = mesh.size()
    cell = count_cell(cfg, shape, mesh, loss_chunk=loss_chunk)
    c = cell["costs"]
    roof = rl.from_counts(c.flops, c.hbm_bytes, chips, coll_bytes=c.coll_bytes,
                          coll_breakdown=c.coll_breakdown,
                          model_flops=rl.model_flops(cfg, shape),
                          hbm_bytes_major=c.hbm_bytes_major, peaks=peaks_for(device),
                          compute_peak="bf16_flops")
    rec = {
        "arch": arch, "shape": shape_name,
        "mesh": "2x16x16" if multi_pod else "16x16",
        "chips": chips,
        # the counted run takes the compile's place
        "lower_s": round(cell["lower_s"], 1), "compile_s": round(cell["run_s"], 1),
        "bytes_per_device": int(c.arg_bytes + c.peak_bytes),
        "temp_bytes": int(c.peak_bytes),
        "arg_bytes": int(c.arg_bytes),
        "ops": c.ops,
        **roof.to_dict(),
    }
    if verbose:
        print(f"[{arch} x {shape_name} x {rec['mesh']}] "
              f"run={rec['compile_s']}s "
              f"args/dev={rec['arg_bytes'] / 2 ** 30:.2f}GiB "
              f"temp/dev={rec['temp_bytes'] / 2 ** 30:.2f}GiB "
              f"Tc={roof.t_compute:.3e}s Tm={roof.t_memory:.3e}s "
              f"(maj {roof.t_memory_major:.3e}) "
              f"Tcoll={roof.t_collective:.3e}s -> {roof.bottleneck} "
              f"(mfu<= {roof.mfu_bound:.2f}..{roof.mfu_bound_major:.2f}, "
              f"useful={roof.flops_ratio:.2f})", flush=True)
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--out", default=None)
    ap.add_argument("--loss-chunk", type=int, default=512)
    ap.add_argument("--device", default=None, help="the fake mesh's device type "
                    "(default: the card's)")
    args = ap.parse_args(argv)

    if args.all:
        cells = [(arch, shape) for arch in ARCH_IDS
                 for shape in applicable_shapes(get(arch))]
    elif args.arch and args.shape:
        cells = [(args.arch, args.shape)]
    else:
        ap.error("--arch/--shape or --all")
    meshes = [False, True] if args.both_meshes else [args.multi_pod]

    t0 = time.time()
    results, failures = [], []
    for mp in meshes:               # one fake group per mesh size
        for arch, shape in cells:
            try:
                results.append(run_cell(arch, shape, multi_pod=mp,
                                        loss_chunk=args.loss_chunk, device=args.device))
            except Exception as e:  # a failure here is a bug in the system
                traceback.print_exc()
                failures.append({"arch": arch, "shape": shape,
                                 "multi_pod": mp, "error": repr(e)})
    wall = time.time() - t0
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"results": results, "failures": failures, "wall_s": wall}, f, indent=1)
    print(f"\n{len(results)} cells OK, {len(failures)} failed in {wall:.1f} s")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
