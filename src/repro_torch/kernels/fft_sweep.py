#!/usr/bin/env python3
"""Time design variants of the port's FFT kernel on one card.

    python3 src/repro_torch/kernels/fft_sweep.py [--shape gpt2 | --shape dtree]

Each variant is `csrc/fft.cu` beside this file with its tuning
constants replaced (the Stockham passes' radix, the blocks per cluster,
the threads per block, and whether the row FFTs share the column
buffers: `Cfg::SHARE`), built for `sm_90a` with the port's nvcc flags
into `build/fft_sweep/` with only the shape's size instantiated, and run
on all four entry points at one of two shapes: `gpt2` (lg M = 14: B =
12, k = 1, N = 32,768, PBS level 1) or `dtree` (lg M = 15, the decision
tree's set: B = 192, k = 1, N = 65,536, base_log 11, level 3).  At
`dtree` the first variant is the cluster of 8 in three buffers that the
port ran before the cluster of 16, and every other variant's outputs are
compared with its outputs bit for bit.  Four probes run beside them:
`phases` records the device clock (`%globaltimer`) in thread 0 of every
block at each phase boundary of the kernel and prints the mean time per
phase; `no_fft` skips the Stockham passes, leaving the loads, root
tables, exchange and stores; `no_twiddle` drops the four-step twiddle
from the last column pass; `local_gather` reads the block's own shared
memory in the gather step instead of its peers'.  The last three compute
wrong results, which go unchecked.  Every other result is checked
against the plain PyTorch version, then timed two ways: one call behind
a device sleep, as `chip_smoke.py` times a kernel, and the mean over 200
back-to-back launches, which is how a blind rotation issues them.  Prints
each variant's residency (clusters at once and blocks per SM of the
digit and torus entry points, `fft_residency`), one line per variant and
entry point, then the card's name and power limit.  Needs CUDA; imports
nothing of JAX.
"""
from __future__ import annotations

import argparse
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
# shape: (B, K, N, level, base_log)
SHAPES = {"gpt2": (12, 2, 32768, 1, 22), "dtree": (192, 2, 65536, 3, 11)}

# shape: {name: (max radix, blocks per cluster, values per thread, SHARE, probe)}
VARIANTS = {
    "gpt2": {
        "r8_p8_v8": (8, 8, 8, False, None),
        "r16_p8_v8": (16, 8, 8, False, None),
        "r8_p16_v8": (8, 16, 8, False, None),
        "r16_p16_v8": (16, 16, 8, False, None),
        "phases": (16, 8, 8, False, "phases"),
        "no_fft": (16, 8, 8, False, "no_fft"),
        "no_twiddle": (16, 8, 8, False, "no_twiddle"),
        "local_gather": (16, 8, 8, False, "local_gather"),
    },
    "dtree": {
        "p8_v8": (16, 8, 8, False, None),              # the cluster of 8: one block an SM
        "p16_v8_share": (16, 16, 8, True, None),       # the port's plan: two blocks an SM
        "p16_v8": (16, 16, 8, False, None),            # three buffers: one block an SM
        "p8_v8_share": (16, 8, 8, True, None),         # the wait moved, one block an SM
        "p16_v16_share": (16, 16, 16, True, None),     # 128 threads a block
        "phases_p8_v8": (16, 8, 8, False, "phases"),
        "phases": (16, 16, 8, True, "phases"),
    },
}
PHASES = ["issue loads + root tables", "prologue", "column FFTs", "cluster barrier 1",
          "gather from peers", "acc loads + wait for peers (SHARE)", "row FFTs",
          "epilogue stores", "wait for peers at exit"]
MARKS = """
__device__ unsigned long long g_marks[65536][10];
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
  return (int)cudaMemcpyFromSymbol(dst, g_marks, (size_t)blocks * 10 * 8);
}
"""
# (pattern, text inserted after the match) of the `phases` probe
MARK_AT = [
    (r"const int b = row / a.J, jj = row % a.J;\n", "  mark(0);\n"),
    (r"hi\[t\] = c2<V>\(\(S\)c, \(S\)s\);\n  \}\n  __syncthreads\(\);\n", "  mark(1);\n"),
    (r"buf0\[j1 \* CS \+ c\] = z;\n  \}\n  __syncthreads\(\);\n", "  mark(2);\n"),
    (r"V\* Y = CF::SHARE \? F : X;[^\n]*\n", "  mark(3);\n"),
    (r"mark\(3\);\n  cluster.sync\(\);\n", "  mark(4);\n"),
    (r"  \}\n  __syncthreads\(\);\n(?=\n  // The torus epilogue)", "  mark(5);\n"),
    (r"if constexpr \(CF::SHARE\) cluster_wait\(\);[^\n]*\n", "  mark(6);\n"),
    (r"const V\* H = [^\n]*\n", "  mark(7);\n"),
    (r"(?=  if constexpr \(!CF::SHARE\) cluster_wait\(\);)", "  mark(8);\n"),
    (r"if constexpr \(!CF::SHARE\) cluster_wait\(\);[^\n]*\n", "  mark(9);\n"),
]


def variant_source(text: str, log_m: int, radix: int, p: int, vpt: int, share: bool,
                   probe: str | None) -> str:
    """fft.cu with the plan's constants replaced and only lg M = `log_m`
    instantiated (plus the probe's marks or cuts)."""
    subs = [
        (r"constexpr int kMaxRadix = \d+;", f"constexpr int kMaxRadix = {radix};"),
        (r"static constexpr int P = [^;]*;", f"static constexpr int P = LOG_M >= 12 ? {p} : 1;"),
        (r"static constexpr bool SHARE = [^;]*;",
         f"static constexpr bool SHARE = {str(share).lower()};"),
        (r"static constexpr int T = [^\n]*;",
         f"static constexpr int T = E / {vpt} < 32 ? 32 : "
         f"(E / {vpt} > 512 ? 512 : E / {vpt});"),
        (r"FFT_CASE\(2\)[^#]*FFT_CASE\(15\)", f"FFT_CASE({log_m})"),   # [^#] spans lines
    ]
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


def log_m(shape: str) -> int:
    return SHAPES[shape][2].bit_length() - 2


def build(shape: str) -> dict:
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build
    OUT.mkdir(parents=True, exist_ok=True)
    text = SRC.read_text()
    lg = log_m(shape)
    jobs = {}
    for name, cfg in VARIANTS[shape].items():
        cu = OUT / f"fft_{shape}_{name}.cu"
        cu.write_text(variant_source(text, lg, *cfg))
        so = OUT / f"libfft_{shape}_{name}.so"
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
        regs = re.findall(rf"fft_kernelILi{lg}ELi(\d)E.*?Used (\d+) registers", log, re.S)
        print(f"built {name}: registers by entry point (0 forward, 1 digits, 2 inverse, "
              f"3 torus) {sorted(regs)}; {'; '.join(spills) or 'no spills'}")
        libs[name] = ctypes.CDLL(str(so))
    return libs


def function(lib, name: str, n_ptr: int, n_int: int):
    fn = getattr(lib, name)
    fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def residency(lib, n: int) -> str:
    """Clusters at once and blocks per SM of the digit (1) and torus (3)
    entry points at N = n."""
    fn = lib.fft_residency
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = []
    for mode in (1, 3):
        clusters, blocks = ctypes.c_int(), ctypes.c_int()
        if fn(n, mode, ctypes.byref(clusters), ctypes.byref(blocks)) != 0:
            raise RuntimeError(f"fft_sweep: fft_residency({n}, {mode}) failed")
        out.append(f"mode {mode}: {clusters.value} clusters, {blocks.value} blocks/SM")
    return "; ".join(out)


def print_phases(lib, ename: str, blocks: int) -> None:
    """Mean time per phase over the blocks of the last launch, and the
    spread of the blocks' start and end times."""
    import numpy as np
    marks = np.zeros((blocks, 10), dtype=np.uint64)
    lib.read_marks.argtypes = [ctypes.c_void_p, ctypes.c_int]
    if lib.read_marks(marks.ctypes.data, blocks) != 0:
        raise RuntimeError("fft_sweep: reading the phase marks failed")
    t = (marks.astype(np.int64) - int(marks[:, 0].min())) / 1e3   # us
    steps = np.diff(t, axis=1).mean(axis=0)
    print(f"phases {ename}: blocks start over {t[:, 0].max():.2f} us, end at "
          f"{t[:, 9].min():.2f}-{t[:, 9].max():.2f} us; mean per phase: "
          + ", ".join(f"{n} {v:.2f}" for n, v in zip(PHASES, steps)))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--shape", choices=sorted(SHAPES), default="gpt2")
    shape = ap.parse_args().shape
    B, K, N, LEVEL, BASE_LOG = SHAPES[shape]
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
    libs = build(shape)

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

    entries = {   # name: (launcher, n_ptr, n_int, args, out, plain, tolerance, rows)
        "fft_forward": ("fft_forward_launch", 2, 2,
                        lambda o: (x.data_ptr(), o.data_ptr(), B * J, N),
                        torch.empty((B * J, 2, M), dtype=torch.float64, device="cuda"),
                        ff.fft_forward_plain(x), 1e-12, B * J),
        "fft_forward_digits": (
            "fft_forward_digits_launch", 3, 5,
            lambda o: (acc.data_ptr(), shifts.data_ptr(), o.data_ptr(), B, K, N,
                       BASE_LOG, LEVEL),
            torch.empty((B, 2, J, M), dtype=torch.float64, device="cuda"),
            ff.fft_forward_digits_plain(acc, shifts, BASE_LOG, LEVEL), 1e-12, B * J),
        "fft_inverse": ("fft_inverse_launch", 2, 2,
                        lambda o: (flat.data_ptr(), o.data_ptr(), B * K, N),
                        torch.empty((B * K, N), dtype=torch.float64, device="cuda"),
                        ff.fft_inverse_plain(flat), 1e-12, B * K),
        "fft_inverse_torus": ("fft_inverse_torus_launch", 3, 3,
                              lambda o: (planes.data_ptr(), acc.data_ptr(), o.data_ptr(),
                                         B, K, N),
                              torch.empty((B, K, N), dtype=torch.int64, device="cuda"),
                              ff.fft_inverse_torus_plain(planes, acc), None, B * K),
    }
    first = {}     # entry point: the first variant's output
    for vname, lib in libs.items():
        _, p, _, _, probe = VARIANTS[shape][vname]
        print(f"{vname}: residency {residency(lib, N)}")
        for ename, (launcher, n_ptr, n_int, args, out, want, tol, rows) in entries.items():
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
            same = ""
            if probe is None:
                ref = first.setdefault(ename, out.clone())
                same = f" bit_identical_to_first {bool(torch.equal(out, ref))}"
            if probe == "phases":
                print_phases(lib, ename, rows * p)
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
                  f"loop_ms {s0.elapsed_time(s1) / 200:.4f} max_diff {d:.3e}{same}")
    print(f"card: {smi}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
