#!/usr/bin/env python3
"""Time design variants of the port's FFT kernel on one card.

    python3 src/repro_torch/kernels/fft_sweep.py

Each variant is `csrc/fft.cu` beside this file with its tuning
constants replaced (the Stockham passes' radix, the blocks per cluster,
the threads per block), built for `sm_90a` with the port's nvcc flags
into `build/fft_sweep/` (only the gpt2 size, lg M = 14, is instantiated),
and run at the gpt2 shapes (B = 12, k = 1, N = 32,768, PBS level 1) on
all four entry points.  Four probes run beside them: `phases` records
the device clock (`%globaltimer`) in thread 0 of every block at each
phase boundary of the kernel and prints the mean time per phase;
`no_fft` skips the Stockham passes, leaving the loads, root tables,
exchange and stores; `no_twiddle` drops the four-step twiddle from the
last column pass; `local_gather` reads the block's own shared memory in
the gather step instead of its peers'.  The last three compute wrong
results, which go unchecked.  Every other result is checked against the
plain PyTorch version, then timed two ways: one call behind a device
sleep, as `chip_smoke.py` times a kernel, and the mean over 200
back-to-back launches, which is how a blind rotation issues them.  Prints
one line per variant and entry point, then the card's name and power
limit.  Needs CUDA; imports nothing of JAX.
"""
from __future__ import annotations

import ctypes
import re
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[3]
SRC = Path(__file__).resolve().with_name("csrc") / "fft.cu"
OUT = ROOT / "build" / "fft_sweep"
SEED = 2509
B, K, N, LEVEL, BASE_LOG = 12, 2, 32768, 1, 22

# name: (max radix, blocks per cluster, values per thread, probe)
VARIANTS = {
    "r8_p8_v8": (8, 8, 8, None),
    "r16_p8_v8": (16, 8, 8, None),
    "r8_p16_v8": (8, 16, 8, None),
    "r16_p16_v8": (16, 16, 8, None),
    "phases": (16, 8, 8, "phases"),
    "no_fft": (16, 8, 8, "no_fft"),
    "no_twiddle": (16, 8, 8, "no_twiddle"),
    "local_gather": (16, 8, 8, "local_gather"),
}
PHASES = ["issue loads + root tables", "prologue", "column FFTs", "cluster barrier 1",
          "gather from peers", "row FFTs", "epilogue stores", "wait for peers"]
MARKS = """
__device__ unsigned long long g_marks[65536][9];
__device__ __forceinline__ void mark(int i) {
  if (threadIdx.x == 0) {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    g_marks[blockIdx.y * gridDim.x + blockIdx.x][i] = t;
  }
}
"""
READ_MARKS = """
extern "C" int read_marks(void* dst, int blocks) {
  return (int)cudaMemcpyFromSymbol(dst, g_marks, (size_t)blocks * 9 * 8);
}
"""
# (pattern, text inserted after the match) of the `phases` probe
MARK_AT = [
    (r"const int b = row / a.J, jj = row % a.J;\n", "  mark(0);\n"),
    (r"hi\[t\] = c2<V>\(\(S\)c, \(S\)s\);\n  \}\n  __syncthreads\(\);\n", "  mark(1);\n"),
    (r"buf0\[j1 \* CS \+ c\] = z;\n  \}\n  __syncthreads\(\);\n", "  mark(2);\n"),
    (r"V\* X = F == buf0 \? buf1 : buf0;\n", "  mark(3);\n"),
    (r"mark\(3\);\n  cluster.sync\(\);\n", "  mark(4);\n"),
    (r"  \}\n  __syncthreads\(\);\n(?=\n  // The torus epilogue)", "  mark(5);\n"),
    (r"const V\* H = [^\n]*\n", "  mark(6);\n"),
    (r"(?=  cluster_wait\(\);   // the peers)", "  mark(7);\n"),
    (r"cluster_wait\(\);   // the peers[^\n]*\n", "  mark(8);\n"),
]


def variant_source(text: str, radix: int, p: int, vpt: int, probe: str | None) -> str:
    subs = [
        (r"constexpr int kMaxRadix = \d+;", f"constexpr int kMaxRadix = {radix};"),
        (r"static constexpr int P = LOG_M >= 12 \? \d+ : 1;",
         f"static constexpr int P = LOG_M >= 12 ? {p} : 1;"),
        (r"static constexpr int T = [^\n]*;",
         f"static constexpr int T = E / {vpt} < 32 ? 32 : "
         f"(E / {vpt} > 512 ? 512 : E / {vpt});"),
        (r"FFT_CASE\(2\)[^#]*FFT_CASE\(15\)", "FFT_CASE(14)"),   # [^#] spans lines
    ]
    if p > 8:   # clusters above 8 blocks need the non-portable size allowed
        subs.append((r"    ready = true;", "    cudaFuncSetAttribute(fft_kernel<LOG_M, MODE, V>, "
                     "cudaFuncAttributeNonPortableClusterSizeAllowed, 1);\n    ready = true;"))
    if probe == "no_fft":
        subs.append((r"if constexpr \(NS >= L\) \{", "if constexpr (true) {"))
    if probe == "no_twiddle":
        subs.append((r"fft_passes<CF, R, CB, CS, true>", "fft_passes<CF, R, CB, CS, false>"))
    if probe == "local_gather":
        subs.append((r"cluster.map_shared_rank\(F, q\)\[", "F["))
    if probe == "phases":
        subs.append((r"namespace \{\n", "namespace {\n" + MARKS))
        subs += [(pat, lambda m, ins=ins: m.group(0) + ins) for pat, ins in MARK_AT]
    for pat, rep in subs:
        text, n = re.subn(pat, rep, text)
        if n != 1:
            raise RuntimeError(f"fft_sweep: pattern {pat!r} matched {n} times")
    return text + (READ_MARKS if probe == "phases" else "")


def build() -> dict:
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build
    OUT.mkdir(parents=True, exist_ok=True)
    text = SRC.read_text()
    jobs = {}
    for name, cfg in VARIANTS.items():
        cu = OUT / f"fft_{name}.cu"
        cu.write_text(variant_source(text, *cfg))
        so = OUT / f"libfft_{name}.so"
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(so), str(cu)]
        jobs[name] = (so, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                           stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in jobs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"fft_sweep: {name} failed to build:\n{log[-3000:]}")
        spills = [ln.strip() for ln in log.splitlines()
                  if "spill" in ln and " 0 bytes spill stores" not in ln]
        regs = re.findall(r"fft_kernelILi14ELi(\d)E.*?Used (\d+) registers", log, re.S)
        print(f"built {name}: registers by entry point (0 forward, 1 digits, 2 inverse, "
              f"3 torus) {sorted(regs)}; {'; '.join(spills) or 'no spills'}")
        libs[name] = ctypes.CDLL(str(so))
    return libs


def function(lib, name: str, n_ptr: int, n_int: int):
    fn = getattr(lib, name)
    fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def print_phases(lib, ename: str, blocks: int) -> None:
    """Mean time per phase over the blocks of the last launch, and the
    spread of the blocks' start and end times."""
    import numpy as np
    marks = np.zeros((blocks, 9), dtype=np.uint64)
    lib.read_marks.argtypes = [ctypes.c_void_p, ctypes.c_int]
    if lib.read_marks(marks.ctypes.data, blocks) != 0:
        raise RuntimeError("fft_sweep: reading the phase marks failed")
    t = (marks.astype(np.int64) - int(marks[:, 0].min())) / 1e3   # us
    steps = np.diff(t, axis=1).mean(axis=0)
    print(f"phases {ename}: blocks start over {t[:, 0].max():.2f} us, end at "
          f"{t[:, 8].min():.2f}-{t[:, 8].max():.2f} us; mean per phase: "
          + ", ".join(f"{n} {v:.2f}" for n, v in zip(PHASES, steps)))


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("fft_sweep: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core import torus
    from repro_torch.kernels import fourstep_fft as ff
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    libs = build()

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    M, J = N // 2, K * LEVEL
    x = torch.randint(-(1 << 21), 1 << 21, (B * J, N), generator=gen,
                      device="cuda").to(torch.float64)
    acc = torus.random_torus(gen, (B, K, N), device="cuda")
    shifts = torch.randint(0, 2 * N, (B,), generator=gen, device="cuda")
    planes = torch.randn((B, 2, K, M), generator=gen, device="cuda",
                         dtype=torch.float64) * 2.0 ** 60
    flat = planes.transpose(1, 2).reshape(B * K, 2, M).contiguous()
    scale = ff.fft_inverse_plain(flat).abs().max().item()
    stream = torch.cuda.current_stream().cuda_stream

    entries = {   # name: (launcher, n_ptr, n_int, args, out, plain, tolerance)
        "fft_forward": ("fft_forward_launch", 2, 2,
                        lambda o: (x.data_ptr(), o.data_ptr(), B * J, N),
                        torch.empty((B * J, 2, M), dtype=torch.float64, device="cuda"),
                        ff.fft_forward_plain(x), 1e-12),
        "fft_forward_digits": (
            "fft_forward_digits_launch", 3, 5,
            lambda o: (acc.data_ptr(), shifts.data_ptr(), o.data_ptr(), B, K, N,
                       BASE_LOG, LEVEL),
            torch.empty((B, 2, J, M), dtype=torch.float64, device="cuda"),
            ff.fft_forward_digits_plain(acc, shifts, BASE_LOG, LEVEL), 1e-12),
        "fft_inverse": ("fft_inverse_launch", 2, 2,
                        lambda o: (flat.data_ptr(), o.data_ptr(), B * K, N),
                        torch.empty((B * K, N), dtype=torch.float64, device="cuda"),
                        ff.fft_inverse_plain(flat), 1e-12),
        "fft_inverse_torus": ("fft_inverse_torus_launch", 3, 3,
                              lambda o: (planes.data_ptr(), acc.data_ptr(), o.data_ptr(),
                                         B, K, N),
                              torch.empty((B, K, N), dtype=torch.int64, device="cuda"),
                              ff.fft_inverse_torus_plain(planes, acc), None),
    }
    for vname, lib in libs.items():
        probe = VARIANTS[vname][3]
        for ename, (launcher, n_ptr, n_int, args, out, want, tol) in entries.items():
            fn = function(lib, launcher, n_ptr, n_int)

            def call():
                rc = fn(*args(out), stream)
                if rc != 0:
                    raise RuntimeError(f"{vname} {ename}: CUDA error {rc}")

            call()
            torch.cuda.synchronize()
            d = (out - want).abs().max().item()
            lim = tol * want.abs().max().item() if tol else 1e-12 * scale + 1
            if d > lim and probe in (None, "phases"):
                raise AssertionError(f"{vname} {ename}: max diff {d:.3e} over {lim:.3e}")
            if probe == "phases":
                print_phases(lib, ename, 24 * VARIANTS[vname][1])
            single = []
            for _ in range(20):
                s0 = torch.cuda.Event(enable_timing=True)
                s1 = torch.cuda.Event(enable_timing=True)
                torch.cuda._sleep(20_000_000)
                s0.record()
                call()
                s1.record()
                s1.synchronize()
                single.append(s0.elapsed_time(s1))
            s0 = torch.cuda.Event(enable_timing=True)
            s1 = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(20_000_000)
            s0.record()
            for _ in range(200):
                call()
            s1.record()
            s1.synchronize()
            print(f"{vname:12s} {ename:19s} single_ms {statistics.median(single):.4f} "
                  f"loop_ms {s0.elapsed_time(s1) / 200:.4f} max_diff {d:.3e}")
    print(f"card: {smi}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
