"""Host-clock times and losses of the LM mesh path at world size 1: five
full-width qwen3-0.6b train steps (bf16, batch 8 x seq 256) through
`launch.train.train` with DTensor placements over one NCCL rank, and the
same steps without a process group, each path's ms per step the median of
steps 2-5, printed as one JSON line beside the card's name and power
limit.  These are the steps of `chip_smoke.py`'s mesh phase.

    python3 src/repro_torch/launch/mesh_step_times.py

It imports the `repro_torch` of the tree it sits in.  To compare two
commits on one card, unpack the other into a git-ignored directory, copy
this file to the same path there, and run the two in turns (A, B, B, A)
in one call, as `one_device_times.py` says.
"""
from __future__ import annotations

import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ARCH, STEPS, BATCH, SEQ = "qwen3-0.6b", 5, 8, 256


def main() -> int:
    src = Path(__file__).resolve().parents[2]
    sys.path.insert(0, str(src))
    import torch
    import torch.distributed as dist
    from repro_torch.launch.train import train
    from repro_torch.runtime.fault import StepRunner

    if not torch.cuda.is_available():
        print("mesh_step_times: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]

    durations = []
    run_step = StepRunner.run

    def timed_run(self, *a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = run_step(self, *a, **kw)
        torch.cuda.synchronize()
        durations.append(time.perf_counter() - t0)
        return out

    kw = dict(steps=STEPS, reduced=False, batch=BATCH, seq=SEQ, log_every=100, device="cuda")
    StepRunner.run = timed_run
    build = src.parent / "build"
    build.mkdir(exist_ok=True)
    store = tempfile.mkdtemp(dir=build, prefix="mesh_times_")
    try:
        plain_losses, _ = train(ARCH, **kw)
        plain_s, durations[:] = list(durations), []
        dist.init_process_group("nccl", store=dist.FileStore(os.path.join(store, "store"), 1),
                                rank=0, world_size=1)
        try:
            mesh_losses, _ = train(ARCH, model_parallel=1, **kw)
        finally:
            dist.destroy_process_group()
    finally:
        StepRunner.run = run_step
        shutil.rmtree(store, ignore_errors=True)
    mesh_s = list(durations)
    steady = lambda s: statistics.median(s[1:]) * 1e3
    print(json.dumps({"tree": str(src.parent), "card": smi, "arch": ARCH,
                      "plain_losses": plain_losses, "mesh_losses": mesh_losses,
                      "loss_gap": max(abs(a - b) for a, b in zip(mesh_losses, plain_losses)),
                      "plain_step_s": plain_s, "mesh_step_s": mesh_s,
                      "plain_ms_per_step": steady(plain_s),
                      "mesh_ms_per_step": steady(mesh_s)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
