"""Readings for the limits of the `correct` check, on the card, in one
process per call:

    python3 perfbench/control.py --workload <cell> --seconds <s> --seeds <n> ... \\
        [--pbs program|float64|float32]

`program` runs the cell as the benchmark does (the lower reading comes
from a dozen seeds of these); `float32` puts the benchmark's own plain
PBS, with its transforms in float32, in the program's place: the
control, which has to come out not correct; `float64` is the same
reference at the precision the configuration states, which has to come
out correct.  Prints one JSON line per seed with the numbers compared.
"""
import argparse
import gc
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--pbs", choices=("program", "float64", "float32"), default="program")
    args = ap.parse_args()
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch
    from perfbench import harness, reference_pbs
    hook = None
    if args.pbs != "program":
        dtype = getattr(torch, args.pbs)
        hook = lambda engine, keys: reference_pbs.install(engine, keys, dtype)  # noqa: E731
    for seed in args.seeds:
        t = time.perf_counter()
        res = harness.run_cell(args.workload, seed, args.seconds, False, root=ROOT,
                               engine_hook=hook)
        print(json.dumps({"workload": args.workload, "pbs": args.pbs, "seed": seed,
                          "correct": res["correct"], "attempted": res["attempted"],
                          "wall_s": time.perf_counter() - t, "metrics": res["metrics"],
                          "checks": res["checks"]}), flush=True)
        del res
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    return 0


if __name__ == "__main__":
    rc = main()
    # a request the control never served leaves its worker running in
    # the program: the readings are out, so end without waiting for it
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(rc)
