#!/usr/bin/env python3
"""Time block shapes of the port's external-product MAC kernel on one card.

    python3 src/repro_torch/kernels/mac_sweep.py

Each variant is `csrc/external_product.cu` beside this file with its two
block-shape constants replaced (`kThreads`, threads per block, one f
each; `kRows`, rows per block), built for `sm_90a` with the port's nvcc
flags into `build/mac_sweep/` (only the gpt2 case J = K = 2 is
instantiated).  At the gpt2 shapes of a CMux step (F = 16,384; 12 rows,
the main path's round, and 288, the radix program's largest) each
variant's result is checked against the plain einsum (1e-9 relative),
then timed as the mean over 200 back-to-back launches behind a device
sleep, beside the byte bound at 3.35 TB/s.  Prints one line per variant
and row count, then the card's name and power limit.  Needs CUDA;
imports nothing of JAX.
"""
from __future__ import annotations

import ctypes
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[3]
SRC = Path(__file__).resolve().with_name("csrc") / "external_product.cu"
OUT = ROOT / "build" / "mac_sweep"
SEED = 2509
ROWS = (12, 288)
J, K, F = 2, 2, 16384
# (threads per block, rows per block); (128, 2) is the shipped shape
VARIANTS = [(128, 1), (128, 2), (128, 4), (128, 8), (128, 16), (64, 2), (256, 2)]
SLEEP_CYCLES = 20_000_000
MEM_RATE = 3.35e12


def variant_source(text: str, threads: int, rows: int) -> str:
    subs = [
        (r"constexpr int kThreads = \d+;", f"constexpr int kThreads = {threads};"),
        (r"constexpr int kRows = \d+;", f"constexpr int kRows = {rows};"),
        (r"EP_CASE\(1, 1\)[^#]*EP_CASE\(9, 3\)", "EP_CASE(2, 2)"),   # [^#] spans lines
    ]
    for pat, rep in subs:
        text, n = re.subn(pat, rep, text)
        if n != 1:
            raise RuntimeError(f"mac_sweep: pattern {pat!r} matched {n} times")
    return text


def build() -> dict:
    from repro_torch.kernels import _build
    OUT.mkdir(parents=True, exist_ok=True)
    text = SRC.read_text()
    jobs = {}
    for threads, rows in VARIANTS:
        name = f"t{threads}_r{rows}"
        cu = OUT / f"mac_{name}.cu"
        cu.write_text(variant_source(text, threads, rows))
        so = OUT / f"libmac_{name}.so"
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(so), str(cu)]
        jobs[(threads, rows)] = (so, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                      stderr=subprocess.STDOUT, text=True))
    libs = {}
    for shape, (so, proc) in jobs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"mac_sweep: {shape} failed to build:\n{log[-3000:]}")
        fn = ctypes.CDLL(str(so)).external_product_mac_launch
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        libs[shape] = fn
    return libs


def b2b_ms(torch, run, launches: int) -> float:
    run()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SLEEP_CYCLES)
    start.record()
    for _ in range(launches):
        run()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / launches


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("mac_sweep: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import external_product as ep

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    libs = build()
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    stream = torch.cuda.current_stream().cuda_stream
    bsk = torch.randn((2, J, K, F), generator=gen, device="cuda", dtype=torch.float64)
    for B in ROWS:
        dig = torch.randn((B, 2, J, F), generator=gen, device="cuda", dtype=torch.float64)
        want = ep.external_product_mac_plain(dig, bsk)
        out = torch.empty_like(want)
        moved = (dig.numel() + bsk.numel() + out.numel()) * 8
        bound = moved / MEM_RATE * 1e3
        for (threads, rows), fn in libs.items():
            def run(fn=fn):
                rc = fn(dig.data_ptr(), bsk.data_ptr(), out.data_ptr(), B, J, K, F, stream)
                if rc:
                    raise RuntimeError(f"mac_sweep: launch failed with CUDA error {rc}")
            out.zero_()
            run()
            torch.cuda.synchronize()
            err = (out - want).abs().max().item() / want.abs().max().item()
            if err > 1e-9:
                raise AssertionError(f"MAC B={B} threads={threads} rows={rows}: "
                                     f"relative error {err:.3e}")
            ms = b2b_ms(torch, run, 200)
            print(f"external_product_mac B={B:3d} threads {threads:3d} rows {rows:2d} "
                  f"{ms:.5f} ms back to back, bound {bound:.5f} ms (bytes, "
                  f"{moved / 1e6:.2f} MB), {100 * bound / ms:.1f}% of bound")
    print(f"card: {smi}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
