"""One PBS round after its keyswitch (`fused_pbs.pbs_small_fused`: the
mod switch, n CMux steps of three launches, the extract) launched
eagerly against the same round replayed from the pack's captured CUDA
graph (`FusedPbsPack.pbs_from_small`), on the same inputs: the host's
enqueue and the device's time per round (CUDA events), each kernel's
mean device time per launch (torch.profiler), what a capture costs and
holds, whether the outputs are bit-identical, and the residency of the
FFT launches at the set's N (`fourstep_fft.residency`).  A third mode,
"replay_spaced", replays a graph captured with a spin kernel of
`--spin` cycles after each launch, so that each kernel starts on an
idle card as eager launches do.  Prints one JSON line beside the
card's name and power limit.

    python3 src/repro_torch/launch/graph_times.py [--params gpt2 | --params <file.json>]
        [--rows 288] [--reps 15] [--spin 40000]

`--params` names a set of `PAPER_PARAMS` or a JSON file whose "params"
object holds `TFHEParams` fields (`perfbench/configs/tfhe-rs-uint8.json`,
the default).  It imports the `repro_torch` of the tree it sits in; the
modes are timed in turns, twice over, since times on the host's clock
move between calls.
"""
from __future__ import annotations

import argparse
import json
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[3]
KERNEL = [(re.compile(r"fft_kernel<\d+, 1,"), "fft_forward_digits"),
          (re.compile(r"fft_kernel<\d+, 3,"), "fft_inverse_torus"),
          (re.compile(r"external_product_mac"), "external_product_mac")]


def kernel_us(prof) -> dict:
    """{kernel: (launches, mean device us)} of the CMux step's kernels."""
    out = {}
    for e in prof.key_averages():
        for pat, name in KERNEL:
            if pat.search(e.key):
                total = getattr(e, "device_time_total", None)
                if total is None:
                    total = e.cuda_time_total
                n, t = out.get(name, (0, 0.0))
                out[name] = (n + e.count, t + total)
    return {k: (n, t / n) for k, (n, t) in out.items()}


def main() -> int:
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    from repro_torch.core import glwe
    from repro_torch.core.params import PAPER_PARAMS, TFHEParams
    from repro_torch.core.pbs import TFHEContext
    from repro_torch.kernels import _build, fourstep_fft
    from repro_torch.kernels.fused_pbs import FusedPbsPack, pbs_small_fused

    ap = argparse.ArgumentParser()
    ap.add_argument("--params", default=str(ROOT / "perfbench/configs/tfhe-rs-uint8.json"))
    ap.add_argument("--rows", type=int, default=288)
    ap.add_argument("--reps", type=int, default=15)
    ap.add_argument("--seed", type=int, default=2609)
    ap.add_argument("--spin", type=int, default=40000)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("graph_times: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    if args.params in PAPER_PARAMS:
        p = PAPER_PARAMS[args.params]
    else:
        p = TFHEParams(name=Path(args.params).stem,
                       **json.loads(Path(args.params).read_text())["params"])

    B = args.rows
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    ctx = TFHEContext.create(gen, p)
    pack = FusedPbsPack.build(ctx.bsk_f, ctx.ksk, p)
    mod = p.plaintext_modulus
    msgs = torch.randint(0, mod, (B,), generator=gen, device="cuda")
    tables = torch.randint(0, mod, (B, mod), generator=gen, device="cuda")
    polys = glwe.make_lut_polys_cached(tables.cpu(), p, device="cuda")
    small = pack.keyswitch(ctx.encrypt(gen, msgs))
    want = tables[torch.arange(B, device="cuda"), msgs].tolist()
    spaced = FusedPbsPack(p, pack.bsk_planes, pack.ksk_limbs)
    launch = _build.launch

    def spin_after(kernel, fn, *a, device):
        launch(kernel, fn, *a, device=device)
        torch.cuda._sleep(args.spin)
    _build.launch = spin_after
    try:
        for _ in range(2):                              # its eager call, its capture
            spaced.pbs_from_small(small, polys)
    finally:
        _build.launch = launch
    modes = {"eager": lambda: pbs_small_fused(small, polys, pack.bsk_planes, p),
             "replay": lambda: pack.pbs_from_small(small, polys),
             "replay_spaced": lambda: spaced.pbs_from_small(small, polys)}

    ref = modes["eager"]()
    pack.pbs_from_small(small, polys)                   # the key's eager call
    torch.cuda.synchronize()
    mem0, res0 = torch.cuda.memory_allocated(), torch.cuda.memory_reserved()
    t0 = time.perf_counter()
    captured = pack.pbs_from_small(small, polys)
    torch.cuda.synchronize()
    capture_ms = (time.perf_counter() - t0) * 1e3
    graph_mb = (torch.cuda.memory_allocated() - mem0) / 1e6
    pool_mb = (torch.cuda.memory_reserved() - res0) / 1e6
    outs = {name: run() for name, run in modes.items()}
    identical = {name: bool(torch.equal(o, ref)) for name, o in {"capture": captured,
                                                                  **outs}.items()}
    right = ctx.decrypt(outs["replay"]).tolist() == want

    times = {name: [] for name in modes}
    for _ in range(2):
        for name, run in modes.items():
            for _ in range(args.reps):
                torch.cuda.synchronize()
                s = torch.cuda.Event(enable_timing=True)
                e = torch.cuda.Event(enable_timing=True)
                s.record()
                t0 = time.perf_counter()
                run()
                host = (time.perf_counter() - t0) * 1e3
                e.record()
                e.synchronize()
                times[name].append((host, s.elapsed_time(e)))
    kernels = {}
    for name, run in modes.items():
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(3):
                run()
            torch.cuda.synchronize()
        kernels[name] = kernel_us(prof)

    def summary(xs):
        return {"median": statistics.median(xs), "min": min(xs), "max": max(xs)}
    row = {"params": p.name, "rows": B, "card": smi, "torch": torch.__version__,
           "spin_cycles": args.spin,
           "bit_identical": identical, "decrypt_right": right,
           "capture_call_ms": capture_ms, "graph_allocated_mb": graph_mb,
           "graph_reserved_mb": pool_mb,
           "fft_residency": fourstep_fft.residency(p.N),
           "host_enqueue_ms": {k: summary([h for h, _ in v]) for k, v in times.items()},
           "device_ms": {k: summary([d for _, d in v]) for k, v in times.items()},
           "kernel_us": {k: {n: {"launches": c, "mean_us": t} for n, (c, t) in v.items()}
                         for k, v in kernels.items()}}
    print(json.dumps(row))
    return 0 if all(identical.values()) and right else 1


if __name__ == "__main__":
    sys.exit(main())
