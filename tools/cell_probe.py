#!/usr/bin/env python
"""Probes of one run of a benchmark cell, for what the benchmark's own
metrics do not show, run from the root of a checkout with a card
(`perfbench.harness.run_cell` on the checkout's own `repro_torch`).

    python3 tools/cell_probe.py trace <seed> [--seconds 51] [--workload uint8-saturated]
    python3 tools/cell_probe.py sync <seed> [--seconds 15] [--workload uint8-saturated]

`trace` makes a `--trace 1` run and prints its metrics, then the traced
segment's FFT launches by their rows (from the launch grid), each row
count with its launches, median time and share of its roofline (the
reader of `fft_roofline`), and the window's fused rounds by padded
rows with their `device_ms`, its engine spans by how the blind rotation
ran (span arg `graph`) and the engine's graph counters.

`sync` makes an untraced run under `torch.cuda.set_sync_debug_mode("warn")`
and prints the calls that made the host wait for the device, by thread
and call site (the last three frames in this repo's code), most first.
"""
from __future__ import annotations

import argparse
import collections
import json
import statistics
import sys
import threading
import traceback
import warnings
from pathlib import Path

ROOT = Path.cwd()


def trace(args) -> None:
    from perfbench import harness
    from perfbench.metrics import kernels
    keep = {}
    res = harness.run_cell(args.workload, args.seed, args.seconds, True, root=ROOT, keep=keep)
    run = keep["run"]
    print(json.dumps({"correct": res["correct"],
                      "metrics": {k: v["value"] for k, v in res["metrics"].items()}}))
    by_rows = collections.defaultdict(list)
    for kind, rows, dur, least in kernels.launches(run) if run.trace is not None else []:
        by_rows[(kind, rows)].append((dur, least))
    for (kind, rows), xs in sorted(by_rows.items()):
        busy = sum(d for d, _ in xs)
        print(f"traced {kind} at {rows:g} rows: {len(xs)} launches, median "
              f"{statistics.median(d for d, _ in xs) * 1e6:.2f} us, roofline "
              f"{100 * sum(m for _, m in xs) / busy:.1f}%")
    window = [s for s in run.spans if run.t0 <= s.ts + s.dur <= run.t1]
    rounds = collections.defaultdict(list)
    for s in window:
        if s.name == "fused_round" and "device_ms" in s.args:
            rounds[s.args.get("padded")].append(s.args["device_ms"])
    for padded, ms in sorted(rounds.items(), key=lambda kv: str(kv[0])):
        print(f"window fused rounds padded to {padded}: {len(ms)}, device_ms median "
              f"{statistics.median(ms):.2f}")
    for name in ("keyswitch", "lut_batch", "lut_batch_small"):
        how = collections.Counter(s.args.get("graph") for s in window if s.name == name)
        if how:
            print(f"window {name} spans by graph: {dict(how)}")
    for name in ("engine.graph_replays", "engine.graph_captures", "engine.graph_eager"):
        print(f"window {name}: {run.delta(name) if name in run.counters else None}")


def sync(args) -> None:
    import torch
    from perfbench import harness
    sites = collections.Counter()
    lock = threading.Lock()

    def show(message, category, filename, lineno, file=None, line=None):
        if "synchroniz" not in str(message):
            return
        ours = [f for f in traceback.extract_stack()[:-1]
                if "repro_torch" in f.filename or "perfbench" in f.filename]
        site = " <- ".join(f"{Path(f.filename).name}:{f.lineno}:{f.name}"
                           for f in ours[-3:][::-1])
        with lock:
            sites[(threading.current_thread().name.split("-")[0], site)] += 1

    warnings.showwarning = show
    warnings.simplefilter("always")
    torch.cuda.set_sync_debug_mode("warn")
    try:
        res = harness.run_cell(args.workload, args.seed, args.seconds, False, root=ROOT)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    print(f"pbs_per_s {res['metrics']['pbs_per_s']['value']:.1f} correct {res['correct']}")
    for (thread, site), n in sites.most_common(25):
        print(f"{n:8d}  {thread:12s} {site}")


def main() -> int:
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    ap = argparse.ArgumentParser()
    ap.add_argument("probe", choices=["trace", "sync"])
    ap.add_argument("seed", type=int)
    ap.add_argument("--seconds", type=float, default=None)
    ap.add_argument("--workload", default="uint8-saturated")
    args = ap.parse_args()
    if args.seconds is None:
        args.seconds = 51.0 if args.probe == "trace" else 15.0
    (trace if args.probe == "trace" else sync)(args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
