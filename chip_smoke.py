#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`src/repro_torch`) on one card.

    python3 chip_smoke.py

Builds every CUDA kernel from `src/repro_torch/kernels/csrc`, then at the
paper's gpt2 parameters (n=1003, N=32768, 6-bit messages, B=12):

1. port keygen on the card from a seeded CUDA generator;
2. each kernel against its plain PyTorch version on the main path's
   shapes (keyswitch bit-exact; FFTs, and the CMux step's digit
   transforms, within 1e-12 of the output scale; MAC within 1e-9
   relative; the step's torus inverse within 1e-12 of the float
   inverse's scale plus one), timed with CUDA events beside its plain
   version, a PyTorch library call where one computes the same function,
   and the card's bound: the larger of its bytes over the memory rate
   and its operations over the peak rate of their type (f64 for the
   FFTs and the MAC, int8 tensor-core operations for the keyswitch);
   then one CMux step through the three PBS kernels against the exact
   product mod 2^64 (`kernels/cmux_accuracy.py`), at gpt2's gadget and
   at xgboost's (PBS level 2): the rms error of its coefficients, which
   the blind rotation adds to the PBS output noise, may exceed the plain
   `torch.fft` pipeline's by at most STEP_ERROR_RATIO;
3. the main path: two chained `lut_batch_tables` rounds on the fused
   backend through one resident pack, each decrypting to its plaintext
   table, the reference backend decrypt-identical on round 1, and the
   per-round kernel launch counts (keyswitch 1, each FFT and the MAC n);
4. one more fused round under `torch.profiler`, which must hold at most
   3 device events per CMux step plus 200: its Chrome trace goes to
   `build/profile_round.json`, and the device time by kernel is printed
   with the device's idle share, that busy time against the wall time of
   the untraced round 2 (tracing slows the host, not the device);
5. the radix path: the quickstart program `((a * b).relu(), a < b)` on
   32-bit integers of 16 two-bit digits, traced and run by
   `Session(ctx, backend=..., kernel_backend="fused")` for the `eager` and
   the `local` backend on one pair of seeded values whose product wraps
   into the negative half.  Each must decrypt to the plaintext oracle,
   run the rounds (and rows per round) that a dry run of the same program
   through a stand-in engine plans, which must be 24 rounds of 753 rows
   in all (the counts that
   tests/test_torch_api.py::test_quickstart32_rounds_match_jax_runtime_at_gpt2
   holds against the JAX package's runtime), and launch the kernels
   rounds x (1, n, n, n) times; each round's rows and wall time are
   printed;
6. the encrypted GPT-2 block (`repro_torch.fhe_ml`) in both lowering
   families, through `Session(ctx, engine, backend=...)` for `eager` and
   `local`, over the main path's gpt2 keys and engine: the radix block
   `lower_gpt2_block_radix(2, bits=16, msg_bits=2, seed=1)` must decrypt
   to its integer oracle mod 2^16, alike on both backends, with every
   output digit's noise under 1/2^(width+2), then each kernel runs at
   its largest round's shapes (96 rows) against its plain version; the
   narrow-LUT block `lower_gpt2_block(4, QuantSpec(3, 0.25, 4), 6,
   seed=1)` must decrypt to the plaintext oracle `interpret`.  Each run's
   PBS calls (rows for rows), logical PBS and launches must equal a dry
   run's plan through a stand-in engine (the radix block: 104 rounds of
   2,080 rows, 1,268 logical PBS; the launches: one `keyswitch_mac` per
   keyswitch stage, n of each FFT and the MAC per PBS call), and the
   eager narrow run's dedup stats the dry run's;
7. each kernel again at the largest round's shapes (288 rows), against
   its plain version, timed one call at a time and back to back (the MAC
   beside `torch.einsum`), and that round under `torch.profiler`
   (`build/profile_round288.json`): device time by kernel, busy and idle
   share, peak device memory (keys, the one resident pack that every
   fused engine of the key shares, with its KSK limb operand, the round's
   working set);
8. the serving runtime (`repro_torch.serve`): four clients at once
   through `Session(ctx, engine, backend="serve")` on the main path's
   keys and engine, started paused — the radix block, a replay of its
   ciphertexts, the narrow block and the quickstart program, on the
   encryptions the earlier phases decrypted.  Each must decrypt to its
   oracle and its eager run, the replay's rows must all ride the
   original's (dedup hits >= 1,268), dedup must dispatch fewer rows than
   were asked for, the fused rounds' padded rows must sum to the
   scheduler's and the engine's counts, and the launches must be one
   keyswitch and n of each FFT and the MAC per fused round; one mid-wave
   fused round is traced (`build/profile_serve_round.json`), each kernel
   runs at the wave's largest round against its plain version, and the
   same wave on two shards must decrypt alike on one resident pack with
   peak memory less than one pack above one shard's;
9. the paper's no-key-reuse baseline on the main path's keys and pack:
   B fresh ciphertexts through `lut_batch` once and `lut_batch_xpu` (B
   one-row rounds, the BSK streamed per ciphertext) once, both decrypting
   to their tables with launches (1, n, n, n) and B x (1, n, n, n); each
   call replayed under `torch.profiler` (device busy, idle share), the
   ratios of the walls and of the busy times, beside the per-round
   traffic model and `launch.pbs_dryrun`'s bound per PBS;
10. seeded traffic: `repro_torch.sim.suite.run_suite` on the main path's
   keys and engine (five scenarios of 12 s, rates anchored to the
   measured capacity): every DONE payload must decrypt to its oracle,
   the virtual runner's reports must repeat exactly, every scenario's
   outcomes must add up to its requests, records and (open loop) arrival
   plan, and the launches must be the engine's rounds x (1, n, n, n).
   The SLO verdicts follow the card's speed, so they are printed beside
   each scenario's expectation, not enforced;
11. the LM stack's serving path (`repro_torch.launch.serve.serve`) at
   full width in bf16 from the port's seeded init: qwen3-0.6b and
   mamba2-130m serve 4 x 32 prompt tokens and 4 x 32 generated ones,
   recurrentgemma-2b 4 x 32 and 4 x 8.  Each prints its walls, tokens/s,
   ms per decode step, peak memory and parameter bytes, one decode step
   traced (device busy, idle share) beside its roofline bound (weights
   and cache bytes at the memory rate, 2 N_active B FLOPs at the bf16
   peak), and must give last logits within LM_BF16_TOL of the port's own
   forward at that position.  Then every reduced config (f32) on the
   card must give the CPU's forward hidden states and decode logits on
   the same weights within LM_CARD_CPU_TOL.  The path launches none of
   the four kernels;
12. LM training (`repro_torch.launch.train.train`) at qwen3-0.6b's full
   width in bf16 with the reference `train`'s defaults (batch 8, seq 256,
   lr 3e-3 under the cosine schedule): run one takes 4 steps and saves,
   run two resumes at step 4, fails at step 6 (the runner's retries
   spent), restores step 4 and finishes at 8, and the same run two
   without the failure runs from a copy of the checkpoint.  Every loss
   must be finite, the first within TRAIN_FIRST_LOSS_TOL of ln V + d
   0.02^2 / 2 (the seeded init against its tied head), the last below
   it; run two's losses must equal the run without the failure within
   TRAIN_RESTART_TOL, and every restore must return the saved tensors
   bit for bit.  Three steps with `compress_grads` must keep a finite
   error-feedback buffer after every step.  One train step at the same
   shapes is timed (host clock), traced (device busy, idle share, top
   device ops) and held against its roofline bound (6 N D FLOPs at the
   bf16 peak, `train_step_bytes` at the memory rate), with its peak
   device memory, the checkpoint's size and save / restore seconds.  Then
   every reduced config (f32) takes TRAIN_REDUCED_STEPS train steps on
   the card and on the CPU from the same weights and batches, within
   TRAIN_CARD_CPU_TOL.  The path launches none of the four kernels;
13. a fused round past the 65,535 rows a launch puts on its grid:
   `lut_batch_tables` at TEST_PARAMS on GRID_ROWS_B rows (65,600 FFT
   digit rows) must decrypt to its tables, launch the forward transform
   once per slice of the batch (two per CMux step) and decrypt like the
   reference engine on its first GRID_ROWS_SAMPLE rows;
14. the multi-device paths on one card (`mesh_phase`): the engine's
   cluster mesh at gpt2, 4 clusters of 12 on the card (the reference
   backend, the only one a mesh takes), a 48-row round bit-identical to
   the one-device reference engine on each cluster's 12 rows and
   decrypt-identical to its one 48-row round (the card's FFT and einsum
   round 48 rows otherwise than 12), and a 45-row round padded by 3, with
   walls, device busy time and peak memory (the keys held once);
   `ConfigError` for the fused backend with a mesh; `build_shards` on a
   2-device set (a mesh engine for `reference`, a one-device engine for
   `fused`, one round each); then one NCCL rank: MESH_TRAIN_STEPS full-
   width qwen3-0.6b train steps through DTensor placements against the
   same steps without a process group (losses, ms per step), `serve`
   both ways (greedy tokens equal, the logits' gap) and GPipe at one
   stage against the sequential stage;
15. `repro_torch.kernels.ops` (`ops_phase`, run after the kernel checks of
   step 2): the reference's wrappers with its f32 planes and int32
   keyswitch digits at the reference tests' shapes and at gpt2's (B = 12
   and 288 rows), each f32 kernel within 2e-5 of the f64 spectrum's scale
   (the MAC within 1e-2) and of its complex64 plain version, the
   keyswitch bit for bit; timed beside its bound, its plain version, the
   complex64 `torch.fft` / `einsum` call and the f64 kernel, with the
   four wrappers' launches counted over one call each;
16. the LM dry run (`dryrun_phase`): DRYRUN_CELLS at published widths on
   fake (16, 16) and (2, 16, 16) meshes in a process of its own, every
   cell's useful share of its counted FLOPs in (0, 1.05] and qwen3's
   FLOPs x chips equal on the two meshes (analytic counts);
17. the six demos (`examples_phase`): `python -m repro_torch.examples.<name>`
   side by side, every got equal to its expect, trace_serve's trace
   valid.

Prints the card, the build time, a line per phase, an `{"ops": ...}`, a
`{"cmux_accuracy":
...}`, a `{"radix": ...}`, a `{"fhe_ml": ...}`, a `{"serve": ...}`, an
`{"xpu": ...}`, a `{"sim": ...}` and a `{"kernels": ...}` JSON line and,
last,
`{"ok": true, "device": {...}}`, with an `{"lm": ...}`, a `{"train":
...}` and a `{"grid_rows": ..., "mesh": ...}` line before the
`{"kernels": ...}` one, and a `{"dryrun": ..., "examples": ...}` line
just before it.  Any failure raises and exits nonzero.
Needs CUDA; imports nothing of JAX.
"""
from __future__ import annotations

import collections
import contextlib
import json
import math
import os
import random
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
SEED = 2509
B = 12
REPEATS = 20
B2B_LAUNCHES = 50           # launches per back-to-back timing
SLEEP_CYCLES = 20_000_000   # about 10 ms of device time at the H100's clocks
# the 32-bit quickstart program at gpt2: rounds and dispatched rows, as the
# JAX package's runtime runs it (tests/test_torch_api.py holds both packages
# to these on the CPU)
QUICKSTART_ROUNDS, QUICKSTART_ROWS = 24, 753
# the radix GPT-2 block lower_gpt2_block_radix(2, bits=16, msg_bits=2,
# seed=1) at gpt2's width: rounds, dispatched rows and logical PBS of its
# dry run (tests/test_torch_fhe_ml.py holds both packages' backends to
# these; the graph's own count, 1,316 PBS, is not what the runtime runs)
GPT2_RADIX_ROUNDS, GPT2_RADIX_ROWS, GPT2_RADIX_PBS = 104, 2080, 1268
# one CMux step's rms coefficient error through the kernels, at most this
# times the plain torch.fft pipeline's on the same inputs
STEP_ERROR_RATIO = 1.25
# the serve wave: a request not done after this many seconds fails the
# phase; the fused round traced under the profiler (mid-wave)
SERVE_TIMEOUT_S = 600
SERVE_PROBE_ROUND = 20
# the sim phase: the suite's virtual seconds per scenario, and the phase's
# own time limit (its overload scenario ends through close(drain=False))
SIM_DURATION_S = 12.0
SIM_TIMEOUT_S = 600
# The card's data-sheet peaks come from repro_torch.launch.roofline.PEAKS:
# memory bytes/s, FP64 FLOP/s (tensor cores), int8 tensor-core OP/s, bf16
# tensor-core FLOP/s.
# The lm phase: (arch, batch, prompt tokens, generated tokens) served at
# full width in bf16.
LM_FULL = (("qwen3-0.6b", 4, 32, 32), ("mamba2-130m", 4, 32, 32),
           ("recurrentgemma-2b", 4, 32, 8))
# Full width, bf16: the last decode logits against the port's forward at
# the last position, max |diff| at most this share of max |logit|.  bf16
# keeps 8 significant bits (spacing 2^-7 of the value); the residual
# stream is rounded after each of 2L sub-layers, in other GEMM shapes in
# decode (B rows) than in the forward (B x T rows): a few percent
# (PERF.md section 5), where a wrong cache slot, position or state reads
# O(1).
LM_BF16_TOL = 0.125
# Reduced configs, f32: the card's forward hidden states and decode
# logits against the CPU's on the same weights (rtol = atol).  Summation
# order differs between the card's and the CPU's kernels; the
# recurrences carry each rounding forward (tests/test_torch_lm.py holds
# the port to the reference at 1e-4 for the same reason).
LM_CARD_CPU_TOL = 1e-4
LM_REDUCED_STEPS = 16
# The train phase: the reference `train`'s defaults at qwen3-0.6b's full
# width (batch 8, seq 256, loss_chunk min(seq, 512), lr 3e-3 under the
# cosine schedule with warmup steps // 10).  Run one takes TRAIN_RESUME_AT
# steps and saves; run two resumes there, fails at TRAIN_FAIL_AT, restores
# and finishes at TRAIN_STEPS.
TRAIN_ARCH, TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ = "qwen3-0.6b", 8, 8, 256
TRAIN_RESUME_AT, TRAIN_FAIL_AT = 4, 6
TRAIN_COMPRESS_STEPS = 3
TRAIN_TIMED_STEPS = 3
# The first loss of the seeded init: the logits of a unit-rms final hidden
# state against a tied head of std 0.02 have variance d * 0.02^2, so the
# log-partition sits at ln V + d * 0.02^2 / 2 above a gold logit of mean 0.
TRAIN_FIRST_LOSS_TOL = 0.05
# Run two (resumed, failed, restored) against the same run two without the
# failure, from a copy of the same checkpoint: loss by loss.
TRAIN_RESTART_TOL = 0.0
# Reduced configs (f32), TRAIN_REDUCED_STEPS train steps at lr TRAIN_LR on
# the card and on the CPU from the same weights and batches: losses within
# TRAIN_CARD_CPU_TOL (relative), the updated parameters within it
# (absolute) but for a TRAIN_CARD_CPU_OUTLIERS share of the elements, which
# must stay within 2 lr per step.  Summation order differs, and Adam
# divides each gradient by its own rms: its first step moves a parameter
# by lr * g / (|g| + eps), so a gradient near zero (or eps) turns its
# rounding into a share of a whole step.
TRAIN_REDUCED_STEPS = 2
TRAIN_LR = 3e-3
TRAIN_CARD_CPU_TOL = 1e-4
TRAIN_CARD_CPU_OUTLIERS = 1e-4
# The grid rows phase: a fused round at TEST_PARAMS whose B K level FFT
# digit rows (65,600) pass the 65,535 a launch puts on its grid, and the
# reference engine on its first rows.
GRID_ROWS_B, GRID_ROWS_SAMPLE = 16400, 64
# The mesh phase: the paper's 4 clusters of 12 on one card; the LM mesh
# path at world size 1 for MESH_TRAIN_STEPS train steps (TRAIN_ARCH at
# TRAIN_BATCH x TRAIN_SEQ) and a MESH_SERVE decode, against the same runs
# without a process group.  One rank holds every shard, so the DTensor
# path runs the one-device path's local ops: its losses should be equal;
# MESH_LOSS_TOL (relative, a bf16 step's rounding) bounds a gap from
# another op order, which the phase prints.
MESH_CLUSTERS = 4
MESH_TRAIN_STEPS = 5
MESH_SERVE = dict(batch=4, prompt_len=32, gen=8)
MESH_LOSS_TOL = 1e-3
# GPipe at one stage against the stage on the whole batch: the reference
# test's bound (f32; the card's GEMMs round a 2-row microbatch otherwise
# than the 16-row batch).
GPIPE_TOL = 1e-5


def cuda_ms(fn, reps: int = REPEATS) -> float:
    """Median over `reps` calls of the device time of one call.

    Each timed call is queued behind a device-side sleep longer than the
    host takes to enqueue it, so the two CUDA events bracket the call's
    device work alone and not the host's launch overhead."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SLEEP_CYCLES)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def b2b_ms(fn, launches: int = B2B_LAUNCHES) -> float:
    """Device time per call of `launches` calls issued back to back,
    queued behind a device-side sleep so the host's enqueue of all of
    them is hidden: the guide's many-launch kernel time."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SLEEP_CYCLES)
    start.record()
    for _ in range(launches):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / launches


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def timed_kernel(run, plain, library, moved: int, n_ops: float, rate: float,
                 mem_rate: float, reps: int = REPEATS, b2b: int = B2B_LAUNCHES,
                 plain_reps: int = 5) -> dict:
    """A kernel's times, one call at a time and back to back, beside its
    plain version's, the library call's (None without one) and its bound:
    the larger of `moved` bytes at `mem_rate` and `n_ops` operations at
    `rate`.  `text` renders them for the log."""
    t_bytes, t_ops = moved / mem_rate * 1e3, n_ops / rate * 1e3
    m = {"ms": cuda_ms(run, reps), "ms_b2b": b2b_ms(run, b2b),
         "plain_ms": cuda_ms(plain, plain_reps) if plain else None,
         "library_ms": cuda_ms(library, reps) if library else None,
         "bound_ms": max(t_bytes, t_ops),
         "bound_by": "bytes" if t_bytes >= t_ops else "operations",
         "bytes_ms": t_bytes, "ops_ms": t_ops, "mb": moved / 1e6}
    m["text"] = (f"kernel_ms {m['ms']:.4f}, back-to-back {m['ms_b2b']:.4f}, plain_ms "
                 f"{m['plain_ms']}, library_ms {m['library_ms']}, bound_ms "
                 f"{m['bound_ms']:.4f} ({m['bound_by']}; bytes {t_bytes:.4f} for "
                 f"{moved / 1e6:.2f} MB, operations {t_ops:.4f} for {n_ops:.3e})")
    return m


def trace_device(run, trace: str):
    """Run `run` once under `torch.profiler`, its Chrome trace to
    `build/<trace>`.  Returns (result, traced wall s, device events,
    {kernel name: [calls, ms]}, device busy ms).  Raises on a trace with
    no device events."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        result = run()
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    path = ROOT / "build" / trace
    path.parent.mkdir(exist_ok=True)
    prof.export_chrome_trace(str(path))
    events = [e for e in json.loads(path.read_text())["traceEvents"]
              if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    if not events:
        raise RuntimeError("profile: the trace holds no device events")
    by_name = collections.defaultdict(lambda: [0, 0.0])
    for e in events:
        by_name[e["name"]][0] += 1
        by_name[e["name"]][1] += e["dur"] / 1e3
    return result, wall, events, by_name, sum(v[1] for v in by_name.values())


def profile_round(run, untraced_s: float, smi: str, steps: int,
                  trace: str = "profile_round.json", other: int = 200) -> dict:
    """Trace one call of `run` and print where the device time goes.
    Raises if the call holds more than 3 device events per CMux step
    (forward, MAC, inverse) plus `other` for the rest of its rounds.
    Returns the call's result and the device busy ms, idle share and ms
    by kernel."""
    result, wall, events, by_name, busy = trace_device(run, trace)
    print(f"profile: {len(events)} device events per round, "
          f"{len(events) / steps:.2f} per CMux step ({steps} steps)")
    if len(events) > 3 * steps + other:
        raise AssertionError(f"profile: {len(events)} device events in a round, more "
                             f"than 3 per CMux step + {other} = {3 * steps + other}")
    print(f"profile: device busy {busy:.1f} ms per round ({len(events)} device "
          f"events; traced round {wall:.3f} s wall), idle share "
          f"{1 - busy / (untraced_s * 1e3):.3f} of the untraced round's "
          f"{untraced_s:.3f} s on {smi}")
    for name, (count, ms) in sorted(by_name.items(), key=lambda kv: -kv[1][1])[:15]:
        print(f"  {ms:9.2f} ms {100 * ms / busy:5.1f}% x{count:6d}  {name[:90]}")
    return {"result": result, "busy_ms": busy, "events": len(events),
            "idle_share": 1 - busy / (untraced_s * 1e3), "traced_wall_s": wall,
            "by_kernel": {k[:60]: {"calls": c, "ms": ms} for k, (c, ms) in
                          sorted(by_name.items(), key=lambda kv: -kv[1][1])[:6]}}


class RoundLog:
    """Duck-typed engine telemetry: one (name, rows, wall seconds) entry
    per PBS round, timed between two device synchronisations."""

    class _Null:
        def inc(self, n=1):
            pass

        def observe(self, v):
            pass

    def __init__(self):
        self.rounds = []

    @contextlib.contextmanager
    def span(self, name, cat=None, rows=0, **_):
        import torch
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        yield
        torch.cuda.synchronize()
        self.rounds.append((name, rows, time.perf_counter() - t0))

    def counter(self, name):
        return self._Null()

    def histogram(self, name):
        return self._Null()


class ShapeEngine:
    """Stand-in engine for a dry run: every PBS returns its input, so a
    program runs its rounds on shapes alone.  Logs each PBS call's rows
    (`lut_batch` or `lut_batch_small`) and counts keyswitch stages (one
    per `lut_batch` or `keyswitch` call), the calls the fused engine
    launches `keyswitch_mac` for."""
    kernel_backend = "fused"

    def __init__(self, device):
        self.device = device
        self.rows = []
        self.keyswitches = 0

    def lut_batch(self, cts, polys):
        self.keyswitches += 1
        return self.lut_batch_small(cts, polys)

    def keyswitch(self, cts):
        self.keyswitches += 1
        return cts

    def lut_batch_small(self, small, polys):
        self.rows.append(int(small.shape[0]))
        return small

    def launches(self, n: int) -> dict:
        """The kernel launches the fused engine makes for these calls."""
        pbs = len(self.rows)
        return {"keyswitch_mac": self.keyswitches, "fft_forward": pbs * n,
                "fft_inverse": pbs * n, "external_product_mac": pbs * n}


def logical_pbs(backend, graph) -> int:
    """Logical PBS a backend ran: its integer context's plus the lut nodes'."""
    ic = getattr(backend, "int_ctx", None) or backend.interp.int_ctx
    return ic.stats["pbs"] + sum(n.n_elements for n in graph.nodes if n.op == "lut")


def radix_phase(ctx, smi: str) -> dict:
    """The quickstart program on 32-bit integers through the eager and the
    local backend; raises on a wrong decrypt, a round count off the plan
    or launch counts off rounds x (1, n, n, n).  Returns per-backend
    results, the largest round's inputs and output (from eager) and the
    eager run's program and encryption."""
    import torch
    from repro_torch.api import IntSpec, Session, make_backend
    from repro_torch.kernels import _build
    p = ctx.params
    rng = random.Random(SEED)
    while True:                     # a product that wraps into the negative half
        a, b = rng.randrange(1 << 32), rng.randrange(1 << 32)
        if (a * b) % (1 << 32) >= 1 << 31:
            break
    want = [0, [int(a < b)]]
    gen = torch.Generator(device=ctx.device).manual_seed(SEED + 1)
    results, largest, sessions, inputs = {}, {}, [], {}
    for backend in ("eager", "local"):
        sess = Session(ctx, backend=backend, kernel_backend="fused")
        sessions.append(sess)
        engine = sess.engine
        log = engine.telemetry = RoundLog()
        if backend == "eager":
            real = engine.lut_batch

            def spy(cts, polys):
                out = real(cts, polys)
                if cts.shape[0] > largest.get("rows", 0):
                    largest.update(rows=cts.shape[0], cts=cts, polys=polys, out=out,
                                   engine=engine)
                return out
            engine.lut_batch = spy
        prog = sess.trace(lambda x, y: ((x * y).relu(), x < y),
                          IntSpec(32, msg_bits=2), IntSpec(32, msg_bits=2))
        enc = sess.encrypt_inputs(gen, [a, b], prog)
        inputs.setdefault("prog", prog)
        inputs.setdefault("enc", enc)
        # the plan: the same program on shapes alone, through a stand-in engine
        dry = ShapeEngine(ctx.device)
        dry_backend = make_backend(backend, ctx, dry)
        dry_backend.execute(prog, enc)
        plan, plan_logical = dry.rows, logical_pbs(dry_backend, prog.graph)
        if (len(plan), sum(plan)) != (QUICKSTART_ROUNDS, QUICKSTART_ROWS):
            raise AssertionError(f"radix {backend}: the dry run plans {len(plan)} rounds "
                                 f"of {sum(plan)} rows, want {QUICKSTART_ROUNDS} of "
                                 f"{QUICKSTART_ROWS}")
        torch.cuda.synchronize()
        _build.reset_launch_counts()
        t0 = time.perf_counter()
        outs = sess.run(prog, enc)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = _build.launch_counts()
        engine.telemetry = None
        got = sess.decrypt_outputs(prog, outs)
        got = [int(got[0]), [int(v) for v in got[1]]]
        logical = logical_pbs(sess.backend, prog.graph)
        rows = [r[1] for r in log.rounds]
        nr = len(log.rounds)
        expect = {"keyswitch_mac": nr, "fft_forward": nr * p.n, "fft_inverse": nr * p.n,
                  "external_product_mac": nr * p.n}
        print(f"radix {backend}: a={a} b={b} decrypt {got} oracle {want}; rounds "
              f"planned {len(plan)} observed {nr}; PBS logical planned {plan_logical} observed "
              f"{logical}, dispatched planned {sum(plan)} observed "
              f"{sum(rows)}; program wall {wall:.3f} s; launches {counts} on {smi}")
        for i, (name, r, sec) in enumerate(log.rounds):
            print(f"  round {i + 1:2d} {name:15s} rows {r:4d} {sec * 1e3:9.2f} ms")
        if got != want:
            raise AssertionError(f"radix {backend}: decrypts {got}, oracle {want}")
        if rows != plan or logical != plan_logical:
            raise AssertionError(f"radix {backend}: rounds of {rows} rows ({logical} PBS) "
                                 f"observed, {plan} ({plan_logical}) planned")
        if counts != expect:
            raise AssertionError(f"radix {backend}: launches {counts}, want {expect}")
        results[backend] = {"a": a, "b": b, "decrypt": got, "oracle": want,
                            "rounds_planned": len(plan), "rounds_observed": nr,
                            "pbs_logical": logical, "pbs_dispatched": sum(rows),
                            "wall_s": wall, "launches": counts,
                            "rounds": [{"op": name, "rows": r, "wall_ms": sec * 1e3}
                                       for name, r, sec in log.rounds]}
    largest["wall_s"] = next(r["wall_ms"] for r in results["eager"]["rounds"]
                             if r["rows"] == largest["rows"]) / 1e3
    return {"results": results, "largest": largest, "sessions": sessions,
            "inputs": inputs}


def run_planned(sess, prog, enc, what: str, smi: str) -> dict:
    """Plan `prog` by a dry run of `sess`'s backend on a `ShapeEngine`,
    then run it on the session's engine with the launch counts set to 0
    just before and read just after.  Raises unless the PBS calls (rows
    for rows), the logical PBS and the launches equal the plan.  Returns
    the outputs, the backend and what was observed."""
    import torch
    from repro_torch.api import make_backend
    from repro_torch.kernels import _build
    engine, graph = sess.engine, prog.graph
    dry = ShapeEngine(engine.device)
    dry_backend = make_backend(sess.backend.name, sess.ctx, dry)
    dry_backend.execute(prog, enc)
    plan_logical, plan_launches = logical_pbs(dry_backend, graph), dry.launches(sess.params.n)
    log = engine.telemetry = RoundLog()
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    try:
        outs = sess.run(prog, enc)
        torch.cuda.synchronize()
    finally:
        engine.telemetry = None
    wall = time.perf_counter() - t0
    counts = _build.launch_counts()
    rows = [r[1] for r in log.rounds]
    ms = [r[2] * 1e3 for r in log.rounds]
    logical = logical_pbs(sess.backend, graph)
    obs = {"rounds_planned": len(dry.rows), "rounds_observed": len(rows),
           "rows_planned": sum(dry.rows), "rows_observed": sum(rows),
           "max_rows": max(rows), "pbs_logical_planned": plan_logical,
           "pbs_logical": logical, "pbs_dispatched": sum(rows), "launches": counts,
           "launches_planned": plan_launches, "wall_s": wall,
           "round_ms": {"mean": statistics.mean(ms), "min": min(ms), "max": max(ms)},
           "rounds": [{"rows": r, "wall_ms": t} for r, t in zip(rows, ms)]}
    print(f"{what}: PBS calls planned {len(dry.rows)} observed {len(rows)}, rows planned "
          f"{sum(dry.rows)} observed {sum(rows)} (at most {max(rows)} a call); PBS logical "
          f"planned {plan_logical} observed {logical}; launches {counts}; program wall "
          f"{wall:.3f} s, round mean {obs['round_ms']['mean']:.2f} min {min(ms):.2f} max "
          f"{max(ms):.2f} ms on {smi}")
    if rows != dry.rows or logical != plan_logical:
        raise AssertionError(f"{what}: PBS calls of {rows} rows ({logical} PBS) observed, "
                             f"{dry.rows} ({plan_logical}) planned")
    if counts != plan_launches:
        raise AssertionError(f"{what}: launches {counts}, planned {plan_launches}")
    return {"outs": outs, "backend": sess.backend, "dry_backend": dry_backend, "obs": obs}


def fhe_ml_phase(ctx, engine, peaks: tuple, smi: str) -> dict:
    """The paper's encrypted GPT-2 block in both lowering families on the
    main path's gpt2 keys and engine, each through a new
    `Session(ctx, engine, backend=...)` per block for `eager` and
    `local`: the radix block (16-bit activations of 2-bit digits),
    decrypting to its integer oracle mod 2^16, alike on both backends,
    every output digit's noise inside 1/2^(width+2), in 104 rounds of
    2,080 rows, then each kernel on the shapes of the block's largest
    round (96 rows) against its plain version; the narrow-LUT block
    (6-bit messages), decrypting to the plaintext oracle `interpret` with
    the eager dedup stats of its dry run.  Every run holds its rounds,
    rows and launches to a dry run's plan.  Raises on any difference;
    returns what each run observed, the kernels' measurements at 96 rows
    and each block's program and encryption."""
    import numpy as np
    import torch
    from repro_torch.api import Session
    from repro_torch.core.integer import RadixCiphertext
    from repro_torch.fhe_ml import QuantSpec, lower
    from repro_torch.fhe_ml.executor import interpret
    from repro_torch.fhe_ml.quantize import calibrate_radix, quantize_to_radix
    p = ctx.params
    gen = torch.Generator(device=ctx.device).manual_seed(SEED + 2)
    budget = 1.0 / 2 ** (p.width + 2)
    results = {"radix_block": {}, "narrow_block": {}}
    inputs = {}

    # the radix block, on the input recipe of its test
    g, meta = lower.lower_gpt2_block_radix(2, bits=16, msg_bits=2, seed=1)
    xf = np.random.default_rng(3).uniform(-1, 1, size=(2,))
    q = quantize_to_radix(xf, calibrate_radix(xf, 16, 2, qmax=meta["input_qmax"]))
    want = [int(v) for v in meta["int_fn"](q) % (1 << 16)]
    enc = None
    for name in ("eager", "local"):
        sess = Session(ctx, engine, backend=name)
        prog = sess.compile(g, meta["in_specs"], meta["out_specs"])
        enc = enc or sess.encrypt_inputs(gen, [q], prog)
        what = f"fhe_ml radix block {name}"
        run = run_planned(sess, prog, enc, what, smi)
        obs = run["obs"]
        got = [int(v) for v in sess.decrypt_outputs(prog, run["outs"])[0]]
        spec = sess.int_ctx.spec(16, 2)
        out = run["outs"][0]
        noise = max(float(np.abs(sess.int_ctx.digit_noise(RadixCiphertext(spec, vec), w)).max())
                    for vec, w in zip(out.reshape(-1, spec.n_digits, out.shape[-1]), want))
        obs.update(params=p.name, values=[float(v) for v in xf], q=[int(v) for v in q],
                   decrypt=got, oracle=want, max_digit_noise=noise, noise_budget=budget)
        print(f"{what}: x={obs['values']} q={obs['q']} decrypt {got} oracle {want}; worst "
              f"digit noise {noise:.3e} (budget {budget:.3e})")
        if got != want:
            raise AssertionError(f"{what}: decrypts {got}, oracle {want}")
        if (obs["rounds_planned"], obs["rows_planned"], obs["pbs_logical_planned"]) != \
                (GPT2_RADIX_ROUNDS, GPT2_RADIX_ROWS, GPT2_RADIX_PBS):
            raise AssertionError(f"{what}: the dry run plans {obs['rounds_planned']} rounds "
                                 f"of {obs['rows_planned']} rows and "
                                 f"{obs['pbs_logical_planned']} PBS, want "
                                 f"{GPT2_RADIX_ROUNDS}, {GPT2_RADIX_ROWS}, {GPT2_RADIX_PBS}")
        if noise >= budget:
            raise AssertionError(f"{what}: digit noise {noise:.3e} over budget {budget:.3e}")
        results["radix_block"][name] = obs
    if results["radix_block"]["eager"]["decrypt"] != results["radix_block"]["local"]["decrypt"]:
        raise AssertionError("fhe_ml radix block: eager and local decrypt apart")
    inputs["radix_block"] = {"prog": prog, "enc": enc}
    # every kernel at the shapes of the block's largest round
    rows = results["radix_block"]["eager"]["max_rows"]
    cts = ctx.encrypt(gen, torch.randint(0, p.plaintext_modulus, (rows,), generator=gen,
                                         device=ctx.device))
    print(f"fhe_ml radix block: each kernel at {rows} rows against its plain version")
    at_rows = kernels_at_rows(cts, engine.fused_pack, gen, peaks, smi)
    del sess, run, cts

    # the narrow-LUT block at gpt2's own 6-bit width
    g, _ = lower.lower_gpt2_block(4, QuantSpec(3, 0.25, 4), p.width, seed=1)
    q = np.random.default_rng(3).integers(0, 8, (4,))
    want = [int(v) for v in interpret(g, [q], p.width)[g.outputs[0]]]
    enc = None
    for name in ("eager", "local"):
        sess = Session(ctx, engine, backend=name)
        prog = sess.compile(g)
        enc = enc or sess.encrypt_inputs(gen, [q], prog)
        what = f"fhe_ml narrow block {name}"
        run = run_planned(sess, prog, enc, what, smi)
        obs = run["obs"]
        got = [int(v) for v in sess.decrypt_outputs(prog, run["outs"])[0]]
        noise = ctx.decrypt_noise(run["outs"][0], torch.tensor(want, device=ctx.device))
        noise = noise.abs().max().item()
        obs.update(params=p.name, q=[int(v) for v in q], decrypt=got, oracle=want,
                   max_noise=noise, noise_budget=budget)
        print(f"{what}: q={obs['q']} decrypt {got} oracle {want}; worst output noise "
              f"{noise:.3e} (budget {budget:.3e})")
        if got != want:
            raise AssertionError(f"{what}: decrypts {got}, interpret {want}")
        if name == "eager":
            obs.update(stats=dict(run["backend"].stats),
                       stats_planned=dict(run["dry_backend"].stats))
            print(f"{what}: stats {obs['stats']}, dry run {obs['stats_planned']}")
            if obs["stats"] != obs["stats_planned"]:
                raise AssertionError(f"{what}: stats {obs['stats']}, dry run "
                                     f"{obs['stats_planned']}")
        if noise >= budget:
            raise AssertionError(f"{what}: output noise {noise:.3e} over budget {budget:.3e}")
        results["narrow_block"][name] = obs
    inputs["narrow_block"] = {"prog": prog, "enc": enc}
    return {"runs": results, "kernels_radix_keys": at_rows, "inputs": inputs}


def canonical(outputs) -> list:
    """Decrypted program outputs as plain lists, for comparison."""
    import numpy as np
    return [np.asarray(v).tolist() for v in outputs]


def serve_wave(ctx, engine, jobs, smi: str, shards: int = 1,
               probe_round: int | None = None) -> dict:
    """One wave through `Session(ctx, engine, backend="serve")`: started
    paused, every job submitted, then resumed, so all requests share the
    barrier from the first round.  The launch counts are set to 0 just
    before `resume()` and read when the last request is done.  Reads each
    `_row_keys` call's host time from its `row_keys` span less its `d2h`
    child (the copies and their device wait), and, at fused round
    `probe_round`, the round's wall between two
    synchronisations and its inputs, for a traced replay.  Raises if a
    request is not done within SERVE_TIMEOUT_S (a barrier that never
    completes fails the phase instead of hanging it)."""
    import torch
    from repro_torch.api import Session
    from repro_torch.kernels import _build
    from repro_torch.obs import Telemetry
    tel = Telemetry(trace=True)
    sess = Session(ctx, engine, backend="serve", telemetry=tel, max_inflight=len(jobs),
                   shards=shards, start_paused=True)
    rt = sess.backend.runtime
    handles = [sess.submit(j["prog"], j["enc"], client_id=j["client"]) for j in jobs]
    probe, calls = {}, [0]

    def probed(name, real):
        def run(x, polys):
            calls[0] += 1
            if calls[0] != probe_round:
                return real(x, polys)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = real(x, polys)
            torch.cuda.synchronize()
            probe.update(name=name, x=x, polys=polys, rows=int(x.shape[0]),
                         wall_s=time.perf_counter() - t0, round=calls[0])
            return out
        return run

    if probe_round is not None:
        engine.lut_batch = probed("lut_batch", engine.lut_batch)
        engine.lut_batch_small = probed("lut_batch_small", engine.lut_batch_small)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    try:
        rt.resume()
        outs = [h.wait(timeout=SERVE_TIMEOUT_S) for h in handles]
        torch.cuda.synchronize()
    finally:
        engine.__dict__.pop("lut_batch", None)
        engine.__dict__.pop("lut_batch_small", None)
    wall = time.perf_counter() - t0
    counts = _build.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    rt.close()
    decrypts = [canonical(sess.decrypt_outputs(j["prog"], [o[i] for i in j["prog"].graph.outputs]))
                for j, o in zip(jobs, outs)]
    spans = tel.recorder.spans()
    rounds = [e.args for e in spans if e.name == "fused_round"]
    # each row_keys span holds one d2h span, on its worker's lane
    keys, d2h = ([s for s in sorted(spans, key=lambda s: (s.tid, s.ts)) if s.name == name]
                 for name in ("row_keys", "d2h"))
    key_ms = [(k.dur - c.dur) * 1e3 for k, c in zip(keys, d2h, strict=True)]
    snap = tel.snapshot()["counters"]
    stats = {k: snap[f"sched.{k}"] for k in ("fused_rounds", "logical_luts", "dispatched_luts",
                                            "padded_luts", "dedup_hits", "ks_dedup_hits")}
    stats["per_shard_rounds"] = [snap[f"serve.shard.{i}.fused_rounds"]
                                 for i in range(len(rt.shards))]
    return {"shards": shards, "decrypts": decrypts, "wall_s": wall, "launches": counts,
            "peak_gb": peak / 1e9, "stats": stats, "rounds": rounds, "counters": snap,
            "row_keys_ms": key_ms, "probe": probe, "runtime": rt,
            "occupancy": [s.scheduler.mean_occupancy for s in rt.shards]}


def serve_phase(ctx, engine, radix, fhe, peaks: tuple, smi: str) -> dict:
    """Four clients served at once by one `ServeRuntime` on the main
    path's gpt2 keys and engine, on encryptions the earlier phases
    already decrypted to their oracles: (a) the radix GPT-2 block, (b) a
    replay of a's ciphertexts, its dedup twin, (c) the narrow-LUT GPT-2
    block, (d) the 32-bit quickstart program.  Every request must decrypt
    to its oracle and to its eager run's values; every row of the twin
    must ride its original (dedup hits >= 1,268); dedup must dispatch
    fewer rows than were asked for; the fused rounds' padded rows must
    sum to `padded_luts` and to the rows the engine ran; the launches must
    be one keyswitch and n of each FFT and the MAC per fused round.  The
    same wave on two shards on the one card must decrypt alike with both
    shards' engines on one resident pack, its peak device memory less
    than one pack above one shard's.  One mid-wave fused round is traced
    under `torch.profiler`, and each kernel runs at the wave's largest
    round against its plain version.  Prints the wave's wall and
    requests per second beside the four programs' local walls, the
    fused rounds and their rows, the dedup hit-rate and the cost of the
    dedup keys (not gated: host-bound walls spread between machines)."""
    import statistics as st
    import torch
    p = ctx.params
    rb, nb = fhe["inputs"]["radix_block"], fhe["inputs"]["narrow_block"]
    runs = fhe["runs"]
    block = {"prog": rb["prog"], "enc": rb["enc"],
             "oracle": [runs["radix_block"]["eager"]["oracle"]],
             "eager": [runs["radix_block"]["eager"]["decrypt"]],
             "local_wall_s": runs["radix_block"]["local"]["wall_s"]}
    jobs = [dict(block, client="a"), dict(block, client="b"),
            {"client": "c", "prog": nb["prog"], "enc": nb["enc"],
             "oracle": [runs["narrow_block"]["eager"]["oracle"]],
             "eager": [runs["narrow_block"]["eager"]["decrypt"]],
             "local_wall_s": runs["narrow_block"]["local"]["wall_s"]},
            {"client": "d", "prog": radix["inputs"]["prog"], "enc": radix["inputs"]["enc"],
             "oracle": radix["results"]["eager"]["oracle"],
             "eager": radix["results"]["eager"]["decrypt"],
             "local_wall_s": radix["results"]["local"]["wall_s"]}]
    one = serve_wave(ctx, engine, jobs, smi, probe_round=SERVE_PROBE_ROUND)
    st1 = one["stats"]
    rows = [r["padded"] for r in one["rounds"]]
    dispatched = [r["dispatched"] for r in one["rounds"]]
    local_sum = sum(j["local_wall_s"] for j in jobs)
    keys_total = sum(one["row_keys_ms"])
    print(f"serve wave (1 shard, 4 clients: radix GPT-2 block, its replay, narrow block, "
          f"32-bit quickstart): wall {one['wall_s']:.3f} s, {len(jobs) / one['wall_s']:.3f} "
          f"requests/s; the four programs' local walls sum to {local_sum:.3f} s "
          f"({[round(j['local_wall_s'], 3) for j in jobs]}); fused rounds "
          f"{st1['fused_rounds']}, rows per round (padded) min {min(rows)} mean "
          f"{st.mean(rows):.2f} max {max(rows)}, dispatched min {min(dispatched)} mean "
          f"{st.mean(dispatched):.2f} max {max(dispatched)}; LUTs logical "
          f"{st1['logical_luts']} dispatched {st1['dispatched_luts']} padded "
          f"{st1['padded_luts']}; dedup hits {st1['dedup_hits']} (hit-rate "
          f"{st1['dedup_hits'] / st1['logical_luts']:.4f}), KS-dedup hits "
          f"{st1['ks_dedup_hits']}; occupancy {one['occupancy'][0]:.3f}; _row_keys "
          f"{keys_total:.2f} ms in {len(one['row_keys_ms'])} calls "
          f"({keys_total / st1['fused_rounds']:.3f} ms per fused round, "
          f"{st.mean(one['row_keys_ms']):.3f} ms per call); launches {one['launches']}; "
          f"peak device memory {one['peak_gb']:.2f} GB on {smi}")
    for j, got in zip(jobs, one["decrypts"]):
        print(f"serve client {j['client']}: decrypt {got} oracle {j['oracle']} eager "
              f"{j['eager']}")
        if not got == canonical(j["oracle"]) == canonical(j["eager"]):
            raise AssertionError(f"serve client {j['client']}: decrypts {got}, oracle "
                                 f"{j['oracle']}, eager {j['eager']}")
    if st1["dedup_hits"] < GPT2_RADIX_PBS:
        raise AssertionError(f"serve: {st1['dedup_hits']} dedup hits, the twin alone "
                             f"should give {GPT2_RADIX_PBS}")
    if not st1["dispatched_luts"] < st1["logical_luts"]:
        raise AssertionError(f"serve: dispatched {st1['dispatched_luts']} of "
                             f"{st1['logical_luts']} LUTs")
    engine_rows = one["counters"]["engine.pbs_rows"]
    if not (sum(rows) == st1["padded_luts"] == engine_rows
            and len(rows) == st1["fused_rounds"] == one["counters"]["engine.lut_batches"]):
        raise AssertionError(f"serve: fused rounds' rows {sum(rows)} in {len(rows)} rounds, "
                             f"padded_luts {st1['padded_luts']}, engine rows {engine_rows}")
    nr = st1["fused_rounds"]
    expect = {"keyswitch_mac": nr, "fft_forward": nr * p.n, "fft_inverse": nr * p.n,
              "external_product_mac": nr * p.n}
    if one["launches"] != expect:
        raise AssertionError(f"serve: launches {one['launches']}, want {expect}")

    # the mid-wave round, replayed under the profiler against its own wall
    probe = one["probe"]
    if not probe:
        raise AssertionError(f"serve: the wave ran fewer than {SERVE_PROBE_ROUND} rounds")
    print(f"serve: fused round {probe['round']} ({probe['name']}, {probe['rows']} rows) took "
          f"{probe['wall_s']:.3f} s in the wave; its replay under the profiler:")
    run = getattr(engine, probe["name"])
    prof = profile_round(lambda: run(probe["x"], probe["polys"]), probe["wall_s"], smi,
                         p.n, "profile_serve_round.json")
    del prof["result"]

    # each kernel at the shapes of the wave's largest round
    gen = torch.Generator(device=ctx.device).manual_seed(SEED + 3)
    cts = ctx.encrypt(gen, torch.randint(0, p.plaintext_modulus, (max(rows),),
                                         generator=gen, device=ctx.device))
    print(f"serve: each kernel at the wave's largest round, {max(rows)} rows, against its "
          "plain version")
    at_rows = kernels_at_rows(cts, engine.fused_pack, gen, peaks, smi)
    del cts, probe

    two = serve_wave(ctx, engine, jobs, smi, shards=2)
    packs = {id(s.engine.fused_pack) for s in two["runtime"].shards}
    pack_gb = sum(engine.fused_pack.resident_key_bytes) / 1e9
    print(f"serve wave on 2 shards: wall {two['wall_s']:.3f} s, fused rounds per shard "
          f"{two['stats']['per_shard_rounds']}, dedup hits "
          f"{two['stats']['dedup_hits']}, launches {two['launches']}, {len(packs)} resident "
          f"pack(s), peak device memory {two['peak_gb']:.2f} GB (1 shard: "
          f"{one['peak_gb']:.2f} GB, one pack {pack_gb:.2f} GB) on {smi}")
    if two["decrypts"] != one["decrypts"]:
        raise AssertionError(f"serve: 2 shards decrypt {two['decrypts']}, 1 shard "
                             f"{one['decrypts']}")
    if len(packs) != 1 or len(two["runtime"].shards) != 2:
        raise AssertionError("serve: the two shards do not share one resident pack")
    if not two["peak_gb"] - one["peak_gb"] < pack_gb:
        raise AssertionError(f"serve: 2 shards peak {two['peak_gb']:.2f} GB, more than one "
                             f"pack over 1 shard's {one['peak_gb']:.2f} GB")
    if two["launches"]["keyswitch_mac"] != two["stats"]["fused_rounds"]:
        raise AssertionError(f"serve: 2 shards launched {two['launches']} for "
                             f"{two['stats']['fused_rounds']} fused rounds")
    keep = ("wall_s", "launches", "peak_gb", "stats", "occupancy", "decrypts")
    return {"clients": [j["client"] for j in jobs],
            "one_shard": {**{k: one[k] for k in keep},
                          "requests_per_s": len(jobs) / one["wall_s"],
                          "local_walls_s": [j["local_wall_s"] for j in jobs],
                          "local_walls_sum_s": local_sum,
                          "rows_padded": {"min": min(rows), "mean": st.mean(rows),
                                          "max": max(rows)},
                          "rows_dispatched": {"min": min(dispatched),
                                              "mean": st.mean(dispatched),
                                              "max": max(dispatched)},
                          "dedup_hit_rate": st1["dedup_hits"] / st1["logical_luts"],
                          "row_keys_ms": {"total": keys_total, "calls": len(one["row_keys_ms"]),
                                          "per_round": keys_total / st1["fused_rounds"],
                                          "per_call": st.mean(one["row_keys_ms"])},
                          "probe_round": {"round": SERVE_PROBE_ROUND, **prof}},
            "two_shards": {k: two[k] for k in keep},
            "pack_gb": pack_gb, "kernels": at_rows}


def xpu_phase(ctx, engine, peaks, smi: str) -> dict:
    """The paper's no-key-reuse baseline against the batched round, on the
    main path's gpt2 keys and resident pack: B fresh ciphertexts under B
    random tables through `lut_batch` once and `lut_batch_xpu` (B one-row
    rounds, so the BSK streams B times) once.  Both must decrypt to the
    tables and to each other; the launches must be (1, n, n, n) for the
    batched round and B x (1, n, n, n) for the XPU pass.  Each call is
    replayed once under `torch.profiler` for its device busy time and idle
    share against its untraced wall; the per-round traffic model and the
    dry run's bound per PBS on the card's peaks are printed beside them.
    Then each kernel runs at the XPU pass's shapes (one row) against its
    plain version."""
    import torch
    from repro_torch.core import glwe
    from repro_torch.kernels import _build
    from repro_torch.launch import pbs_dryrun
    from repro_torch.launch.roofline import pbs_round_model
    p = ctx.params
    gen = torch.Generator(device=ctx.device).manual_seed(SEED + 4)
    msgs = torch.randint(0, p.plaintext_modulus, (B,), generator=gen, device=ctx.device)
    cts = ctx.encrypt(gen, msgs)
    rng = torch.Generator().manual_seed(SEED + 4)
    tables = torch.stack([torch.randperm(p.plaintext_modulus, generator=rng)
                          for _ in range(B)])
    polys = glwe.make_lut_polys_cached(tables, p, device=ctx.device)
    want = tables[torch.arange(B), msgs.cpu()].tolist()
    per_round = {"keyswitch_mac": 1, "fft_forward": p.n, "fft_inverse": p.n,
                 "external_product_mac": p.n}
    runs = {}
    for name, run in (("batched", lambda: engine.lut_batch(cts, polys)),
                      ("xpu", lambda: engine.lut_batch_xpu(cts, polys))):
        torch.cuda.synchronize()
        _build.reset_launch_counts()
        t0 = time.perf_counter()
        refreshed = run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = _build.launch_counts()
        got = ctx.decrypt(refreshed).cpu().tolist()
        rounds = 1 if name == "batched" else B
        expect = {k: rounds * v for k, v in per_round.items()}
        print(f"xpu phase, {name}: {B} PBS in {rounds} round(s), wall {wall:.3f} s, "
              f"launches {counts}; decrypt {got} want {want} on {smi}")
        if got != want:
            raise AssertionError(f"xpu phase, {name}: decrypts {got}, tables give {want}")
        if counts != expect:
            raise AssertionError(f"xpu phase, {name}: launches {counts}, want {expect}")
        prof = profile_round(run, wall, smi, rounds * p.n, f"profile_xpu_{name}.json",
                             other=200 * rounds)
        del prof["result"]
        runs[name] = {"wall_s": wall, "launches": counts, "decrypt": got, **prof}
    bat, xpu = runs["batched"], runs["xpu"]
    model = pbs_round_model(p, B, peaks)
    dry = {r["variant"]: r for r in pbs_dryrun.run(p.name, B, peaks)}
    bound = {k: r["per_pbs_bound_ms"] for k, r in dry.items()}
    out = {"rows": B, "params": p.name, "tables_decrypt": want, "runs": runs,
           "wall_ratio": xpu["wall_s"] / bat["wall_s"],
           "busy_ratio": xpu["busy_ms"] / bat["busy_ms"],
           "model": {"fused_bytes": model.fused_bytes, "unfused_bytes": model.unfused_bytes,
                     "reuse_factor": model.reuse_factor, "t_memory_s": model.t_memory},
           "per_pbs_bound_ms": bound,
           "per_pbs_bound_major_ms": {k: r["per_pbs_bound_major_ms"] for k, r in dry.items()}}
    print(f"xpu phase: XPU / batched wall {xpu['wall_s']:.3f} / {bat['wall_s']:.3f} s = "
          f"{out['wall_ratio']:.2f}x, device busy {xpu['busy_ms']:.1f} / {bat['busy_ms']:.1f} "
          f"ms = {out['busy_ratio']:.2f}x, idle share {xpu['idle_share']:.3f} / "
          f"{bat['idle_share']:.3f}; model at B={B}: fused {model.fused_bytes} B, unfused "
          f"{model.unfused_bytes} B, reuse factor {model.reuse_factor:.3f}; dry-run bound per "
          f"PBS {bound['taurus-batched']:.4f} ms batched, {bound['xpu-per-ct']:.4f} ms per-ct "
          f"on {smi}")
    print("xpu phase: each kernel at the XPU pass's one-row rounds, against its plain "
          "version")
    out["kernels_1row"] = kernels_at_rows(cts[:1], engine.fused_pack, gen, peaks, smi)
    return out


def sim_phase(ctx, engine, peaks, smi: str) -> dict:
    """`repro_torch.sim.suite.run_suite` on the main path's gpt2 keys and
    engine (8-bit integers of 2-bit digits, max_inflight 4, the measured
    capacity anchor, SIM_DURATION_S virtual seconds per scenario), run on a
    thread of its own under SIM_TIMEOUT_S.  The launch counts are set to 0
    just before the suite and read just after.  Hard checks: every DONE
    payload decrypts to its oracle (the suite raises otherwise), the
    virtual runner's reports are identical, every scenario's outcome
    tallies sum to its requests and to its records (an open-loop
    scenario's to its arrival plan), and the kernels launched equal the
    engine's PBS rounds x (1, n, n, n).  The SLO verdicts follow the card's
    speed: they are printed beside each scenario's expectation and not
    enforced (the port's benchmark bounds them later).  Then each kernel
    runs at the shapes of the phase's largest round against its plain
    version."""
    import threading
    import torch
    from repro_torch.kernels import _build
    from repro_torch.obs import Telemetry
    from repro_torch.sim import arrival_plan, standard_suite, suite
    p = ctx.params
    tel = engine.telemetry = Telemetry()
    box = {}

    def work():
        try:
            box["result"] = suite.run_suite(ctx, engine, duration_s=SIM_DURATION_S)
        except Exception as e:          # re-raised on the main thread below
            box["error"] = e

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    worker = threading.Thread(target=work, daemon=True)
    worker.start()
    worker.join(SIM_TIMEOUT_S)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _build.launch_counts()
    engine.telemetry = None
    if worker.is_alive():
        raise AssertionError(f"sim: the suite did not finish within {SIM_TIMEOUT_S} s")
    if "error" in box:
        raise box["error"]
    res = box["result"]
    peak = torch.cuda.max_memory_allocated() / 1e9
    rounds = tel.snapshot()["counters"]["engine.lut_batches"]
    expect = {"keyswitch_mac": rounds, "fft_forward": rounds * p.n,
              "fft_inverse": rounds * p.n, "external_product_mac": rounds * p.n}
    print(f"sim: capacity anchor {res['capacity_rps']:.4f} requests/s; {rounds} engine PBS "
          f"rounds, launches {counts}; phase wall {wall:.3f} s; peak device memory "
          f"{peak:.2f} GB on {smi}")
    scenarios = standard_suite(capacity_rps=res["capacity_rps"], duration_s=SIM_DURATION_S)
    for sc, row in zip(scenarios, res["rows"]):
        print(f"sim scenario {row['scenario']}: requests {row['requests']} done "
              f"{row['done']} timeout {row['timeout']} abandoned {row['abandoned']} failed "
              f"{row['failed']}; p50 {row['p50_s']} s, p99 {row['p99_s']} s, queue-wait p99 "
              f"{row['queue_wait_p99_s']} s; goodput {row['goodput_rps']} requests/s; SLO "
              f"{'PASS' if row['slo_ok'] else 'FAIL'}, expected "
              f"{'PASS' if row['expect_ok'] else 'FAIL'}; wall {row['wall_s']:.3f} s on {smi}")
        tally = row["done"] + row["timeout"] + row["abandoned"] + row["failed"]
        if not tally == row["requests"] == row["records"]:
            raise AssertionError(f"sim {row['scenario']}: outcomes sum to {tally}, "
                                 f"{row['requests']} requests, {row['records']} records")
        if sc.arrival.open_loop:
            plan = arrival_plan(sc.arrival, sc.population, sc.duration_s, sc.seed)
            if len(plan) != row["records"]:
                raise AssertionError(f"sim {row['scenario']}: {row['records']} records for "
                                     f"{len(plan)} planned arrivals")
        if row["payloads_ok"] != row["done"]:
            raise AssertionError(f"sim {row['scenario']}: {row['payloads_ok']} of "
                                 f"{row['done']} DONE payloads decrypt to their oracle")
    if not (res["virtual_deterministic"] and all(r["virtual_deterministic"]
                                                 for r in res["rows"])):
        raise AssertionError("sim: the virtual runner's reports differ between two runs")
    if rounds == 0 or counts != expect:
        raise AssertionError(f"sim: launches {counts} for {rounds} engine rounds, want "
                             f"{expect}")
    largest = int(tel.snapshot()["histograms"]["engine.lut_batch_rows"]["max"])
    gen = torch.Generator(device=ctx.device).manual_seed(SEED + 5)
    cts = ctx.encrypt(gen, torch.randint(0, p.plaintext_modulus, (largest,), generator=gen,
                                         device=ctx.device))
    print(f"sim: each kernel at the phase's largest round, {largest} rows, against its "
          "plain version")
    at_rows = kernels_at_rows(cts, engine.fused_pack, gen, peaks, smi)
    return {"capacity_rps": res["capacity_rps"], "duration_s": SIM_DURATION_S,
            "rows": res["rows"], "engine_rounds": rounds, "launches": counts,
            "wall_s": wall, "peak_gb": peak, "largest_round_rows": largest,
            "kernels": at_rows}


def lm_phase(smi: str, peaks) -> dict:
    """The LM stack's serving path: each of LM_FULL through
    `repro_torch.launch.serve.serve` at full width (the port's seeded
    init, bf16), its last logits against the port's own forward, one
    decode step traced and held against the roofline bound; then every
    reduced config's forward and decode logits on the card against the
    CPU on the same weights.  The path launches none of the FHE kernels."""
    import torch
    from repro_torch import configs
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.kernels import _build
    from repro_torch.launch import roofline as rl
    from repro_torch.launch.serve import serve
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.launch.train import reduced_config
    from repro_torch.models import build

    full = {}
    _build.reset_launch_counts()
    for arch, batch, prompt_len, gen in LM_FULL:
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        run = serve(arch, reduced=False, batch=batch, prompt_len=prompt_len, gen=gen)
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() - base
        model, cfg = run.model, run.model.cfg
        if run.tokens.shape != (batch, gen) or not torch.isfinite(run.logits).all():
            raise AssertionError(f"lm {arch}: tokens {run.tokens.shape}, logits not finite")
        seq = torch.cat([run.prompts, torch.as_tensor(run.tokens, dtype=torch.int32,
                                                      device=run.prompts.device)], dim=1)
        want = make_prefill_step(cfg)(model, {"tokens": seq})
        err = (run.logits - want).abs().max().item()
        scale = want.abs().max().item()
        rms = ((run.logits - want).norm() / want.norm()).item()

        weight_bytes = nbytes(*model.parameters())
        cache_bytes = nbytes(*(v for c in run.cache for v in c.values() if torch.is_tensor(v)))
        flops = rl.model_flops(cfg, ShapeSpec("serve", prompt_len + gen, batch, "decode"))
        roof = rl.from_counts(flops, weight_bytes + cache_bytes, model_flops=flops,
                              peaks=peaks, compute_peak="bf16_flops")
        step_ms = run.decode_s / gen * 1e3
        # one decode step at position 0 of a fresh cache of the same size:
        # it reads the same weights and cache bytes as any other step
        cache = model.init_cache(batch, prompt_len + gen)
        tok = run.prompts[:, :1]
        pos = torch.zeros((batch, 1), dtype=torch.int32, device=tok.device)
        model.decode_step(cache, tok, pos)
        cache = model.init_cache(batch, prompt_len + gen)
        _, traced_s, events, by_name, busy = trace_device(
            lambda: model.decode_step(cache, tok, pos), f"profile_lm_{arch}.json")
        row = {
            "layers": cfg.num_layers, "d_model": cfg.d_model, "dtype": cfg.dtype,
            "batch": batch, "prompt_len": prompt_len, "gen": gen,
            "params": sum(p.numel() for p in model.parameters()),
            "param_bytes": weight_bytes, "cache_bytes": cache_bytes,
            "serve_wall_s": wall, "prefill_s": run.prefill_s, "decode_s": run.decode_s,
            "tokens_per_s": batch * gen / run.decode_s, "ms_per_decode_step": step_ms,
            "bound_ms": roof.t_bound * 1e3, "bound_by": roof.bottleneck,
            "t_memory_ms": roof.t_memory * 1e3, "t_compute_ms": roof.t_compute * 1e3,
            "step_over_bound": step_ms / (roof.t_bound * 1e3),
            "traced_step_busy_ms": busy, "traced_step_events": len(events),
            "traced_step_idle_share": 1 - busy / step_ms,
            "peak_gb": peak / 1e9, "decode_vs_forward_max_abs_err": err,
            "max_abs_logit": scale, "relative_err": err / scale, "rms_relative_err": rms,
            "first_tokens": run.tokens[:, :8].tolist()}
        full[arch] = row
        print(f"lm {arch} full width ({row['layers']} layers, d {row['d_model']}, "
              f"{row['params'] / 1e9:.3f} B params, {weight_bytes / 1e9:.3f} GB {cfg.dtype}): "
              f"prefill {prompt_len} x{batch} {run.prefill_s:.3f} s, decode {gen} x{batch} "
              f"{run.decode_s:.3f} s, {row['tokens_per_s']:.1f} tok/s, "
              f"{step_ms:.3f} ms per decode step; peak device memory {peak / 1e9:.2f} GB "
              f"above the earlier phases' on {smi}")
        print(f"lm {arch} decode step bound {row['bound_ms']:.4f} ms ({roof.bottleneck}: "
              f"weights + cache {(weight_bytes + cache_bytes) / 1e9:.4f} GB at "
              f"{peaks.mem_bw / 1e12:.2f} TB/s = {row['t_memory_ms']:.4f} ms; "
              f"2 N_active B = {flops:.4e} FLOPs at bf16 {peaks.bf16_flops / 1e12:.0f} "
              f"TFLOP/s = {row['t_compute_ms']:.5f} ms); measured step "
              f"{row['step_over_bound']:.1f}x the bound; traced step: device busy "
              f"{busy:.3f} ms over {len(events)} device events ({traced_s * 1e3:.1f} ms "
              f"traced wall), idle share {row['traced_step_idle_share']:.3f} of the "
              f"untraced step")
        for name, (count, ms) in sorted(by_name.items(), key=lambda kv: -kv[1][1])[:6]:
            print(f"  {ms:9.4f} ms {100 * ms / busy:5.1f}% x{count:5d}  {name[:90]}")
        print(f"lm {arch} decode vs forward at position {prompt_len + gen - 1}: max |diff| "
              f"{err:.4g} of max |logit| {scale:.4g} (relative {err / scale:.4g}, limit "
              f"{LM_BF16_TOL}), rms relative {rms:.4g}; first tokens {row['first_tokens']}")
        if not err <= LM_BF16_TOL * scale:
            raise AssertionError(f"lm {arch}: decode disagrees with forward at full width")
        del run, model, cache, want
        torch.cuda.empty_cache()

    reduced = {}
    for arch in configs.ARCH_IDS:
        cfg = reduced_config(arch)
        g = torch.Generator().manual_seed(SEED)
        cpu = build(cfg, "cpu").init(g)
        card = build(cfg, "cuda")
        card.load_state_dict(cpu.state_dict())
        rows, T = 2, LM_REDUCED_STEPS
        toks = torch.randint(0, cfg.vocab_size, (rows, T), generator=g, dtype=torch.int32)
        fe = (torch.randn((rows, cfg.frontend_len, cfg.frontend_dim), generator=g)
              if cfg.frontend != "none" else None)
        with torch.no_grad():
            h_cpu, _ = cpu(toks, fe)
            h_card, _ = card(toks.cuda(), None if fe is None else fe.cuda())
        errs = {"forward": (h_card.cpu() - h_cpu).abs().max().item(), "decode": 0.0}
        ok = torch.allclose(h_card.cpu(), h_cpu, rtol=LM_CARD_CPU_TOL, atol=LM_CARD_CPU_TOL)
        c_cpu, c_card = cpu.init_cache(rows, T), card.init_cache(rows, T)
        for i in range(T):
            pos = torch.full((rows, 1), i, dtype=torch.int32)
            l_cpu, c_cpu = cpu.decode_step(c_cpu, toks[:, i:i + 1], pos)
            l_card, c_card = card.decode_step(c_card, toks[:, i:i + 1].cuda(), pos.cuda())
            errs["decode"] = max(errs["decode"], (l_card.cpu() - l_cpu).abs().max().item())
            ok &= torch.allclose(l_card.cpu(), l_cpu, rtol=LM_CARD_CPU_TOL,
                                 atol=LM_CARD_CPU_TOL)
        reduced[arch] = {"forward_max_abs_err": errs["forward"],
                         "decode_max_abs_err": errs["decode"]}
        print(f"lm {cfg.name} (f32) card against CPU: forward hidden max |diff| "
              f"{errs['forward']:.3e}, {T} decode steps' logits max |diff| "
              f"{errs['decode']:.3e} (rtol = atol = {LM_CARD_CPU_TOL})")
        if not ok:
            raise AssertionError(f"lm {cfg.name}: the card disagrees with the CPU")
    launches = _build.launch_counts()
    print(f"lm phase kernel launches: {launches}")
    if any(launches.values()):
        raise AssertionError("the LM path launched FHE kernels")
    return {"full": full, "reduced_card_vs_cpu": reduced, "bf16_tol": LM_BF16_TOL,
            "card_cpu_tol": LM_CARD_CPU_TOL}


def _bits(t):
    """A tensor's bytes as integers, for a bit-for-bit comparison."""
    import torch
    return t.view({1: torch.int8, 2: torch.int16, 4: torch.int32, 8: torch.int64}[t.element_size()])


def train_phase(smi: str, peaks) -> dict:
    """The LM training path (`repro_torch.launch.train.train`) at full
    width: run one, run two with an injected failure and a restore, the
    same run two without the failure, every checkpoint restore held bit
    for bit against what was saved; gradient compression; one train step
    timed, traced and held against its roofline bound; then every reduced
    config's train steps on the card against the CPU.  The path launches
    none of the FHE kernels."""
    import shutil
    import torch
    from repro_torch import configs
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.data import DataConfig, SyntheticLMData
    from repro_torch.kernels import _build
    from repro_torch.launch import roofline as rl
    from repro_torch.launch.steps import make_train_step
    from repro_torch.launch.train import reduced_config, train
    from repro_torch.models import build
    from repro_torch.optim import AdamW, cosine_schedule
    from repro_torch.runtime import Int8Compressor

    cfg = configs.get(TRAIN_ARCH)
    root = ROOT / "build" / "train_ckpt"
    shutil.rmtree(root, ignore_errors=True)
    kw = dict(reduced=False, batch=TRAIN_BATCH, seq=TRAIN_SEQ, log_every=1)
    _build.reset_launch_counts()

    # every save keeps a copy of its tree on the card; every restore is
    # compared with it bit for bit and timed
    saved, io = {}, {"save_s": [], "restore_s": [], "restores": []}
    save, restore = CheckpointManager.save, CheckpointManager.restore

    def timed_save(self, step, tree):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        path = save(self, step, tree)
        io["save_s"].append(time.perf_counter() - t0)
        saved[(Path(self.dir).name, step)] = {
            k: {n: t.detach().clone() for n, t in v.items()} for k, v in tree.items()}
        return path

    def checked_restore(self, like, step=None):
        t0 = time.perf_counter()
        tree, step = restore(self, like, step)
        torch.cuda.synchronize()
        io["restore_s"].append(time.perf_counter() - t0)
        want = saved[(Path(self.dir).name, step)]
        same = all(torch.equal(_bits(tree[k][n]), _bits(want[k][n]))
                   for k in want for n in want[k])
        io["restores"].append({"dir": Path(self.dir).name, "step": step, "bitwise": same})
        return tree, step

    CheckpointManager.save, CheckpointManager.restore = timed_save, checked_restore
    try:
        t0 = time.perf_counter()
        l1, _ = train(TRAIN_ARCH, steps=TRAIN_RESUME_AT, ckpt_dir=str(root / "a"), **kw)
        wall1 = time.perf_counter() - t0
        # hard links: a checkpoint's files are never rewritten in place
        shutil.copytree(root / "a", root / "b", copy_function=os.link)
        saved[("b", TRAIN_RESUME_AT)] = saved[("a", TRAIN_RESUME_AT)]
        t0 = time.perf_counter()
        l2, stats2 = train(TRAIN_ARCH, steps=TRAIN_STEPS, ckpt_dir=str(root / "a"),
                           fail_at_step=TRAIN_FAIL_AT, **kw)
        wall2 = time.perf_counter() - t0
        clean, _ = train(TRAIN_ARCH, steps=TRAIN_STEPS, ckpt_dir=str(root / "b"), **kw)
    finally:
        CheckpointManager.save, CheckpointManager.restore = save, restore
    ckpt_dir = root / "a" / f"step_{TRAIN_STEPS:08d}"
    ckpt_bytes = sum(f.stat().st_size for f in ckpt_dir.iterdir())
    del saved
    torch.cuda.empty_cache()
    shutil.rmtree(root, ignore_errors=True)

    # gradient compression through train(): the error-feedback buffer after
    # every step
    efs = []
    roundtrip = Int8Compressor.roundtrip

    def checked_roundtrip(self, grads, ef_state, groups=None):
        out, ef = roundtrip(self, grads, ef_state, groups)
        efs.append({"tensors": len(ef), "finite": all(bool(torch.isfinite(e).all())
                                                      for e in ef.values()),
                    "max_abs": max(float(e.abs().max()) for e in ef.values())})
        return out, ef

    Int8Compressor.roundtrip = checked_roundtrip
    try:
        lc, _ = train(TRAIN_ARCH, steps=TRAIN_COMPRESS_STEPS, compress_grads=True, **kw)
    finally:
        Int8Compressor.roundtrip = roundtrip
    torch.cuda.empty_cache()

    # one train step at the same shapes: timed on the host clock, traced,
    # against the bound
    model = build(cfg)
    model.init(torch.Generator(model.device).manual_seed(0))
    opt = AdamW(lr=cosine_schedule(3e-3, warmup=0, total=TRAIN_STEPS))
    step = make_train_step(cfg, opt, loss_chunk=min(TRAIN_SEQ, 512))
    data = SyntheticLMData(DataConfig(cfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH))
    batches = [data.batch(i) for i in range(TRAIN_TIMED_STEPS + 2)]
    state = opt.init(dict(model.named_parameters()))
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    state, _ = step(model, state, batches[0], 0)              # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(1, TRAIN_TIMED_STEPS + 1):
        state, metrics = step(model, state, batches[i], i)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / TRAIN_TIMED_STEPS * 1e3
    peak = torch.cuda.max_memory_allocated()
    i = TRAIN_TIMED_STEPS + 1
    _, traced_s, events, by_name, busy = trace_device(
        lambda: step(model, state, batches[i], i), "profile_train_step.json")
    n_params = sum(p.numel() for p in model.parameters())
    param_bytes = nbytes(*model.parameters())
    tokens = TRAIN_BATCH * TRAIN_SEQ
    flops = rl.model_flops(cfg, ShapeSpec("train", TRAIN_SEQ, TRAIN_BATCH, "train"))
    step_bytes = rl.train_step_bytes(param_bytes, n_params)
    roof = rl.from_counts(flops, step_bytes, model_flops=flops, peaks=peaks,
                          compute_peak="bf16_flops")
    state_bytes = nbytes(*state["m"].values(), *state["v"].values())
    del model, state, step, batches
    torch.cuda.empty_cache()

    expected_first = math.log(cfg.vocab_size) + cfg.d_model * 0.02 ** 2 / 2
    row = {
        "arch": TRAIN_ARCH, "layers": cfg.num_layers, "d_model": cfg.d_model,
        "vocab": cfg.vocab_size, "dtype": cfg.dtype, "batch": TRAIN_BATCH,
        "seq": TRAIN_SEQ, "steps": TRAIN_STEPS, "params": n_params,
        "param_bytes": param_bytes, "optimizer_state_bytes": state_bytes,
        "losses_run_one": l1, "losses_run_two": l2, "losses_run_two_clean": clean,
        "run_two_stats": stats2, "wall_run_one_s": wall1, "wall_run_two_s": wall2,
        "first_loss": l1[0], "first_loss_expected": expected_first,
        "restores": io["restores"], "ckpt_bytes": ckpt_bytes,
        "ckpt_save_s": io["save_s"], "ckpt_restore_s": io["restore_s"],
        "compress_losses": lc, "compress_ef": efs,
        "ms_per_step": step_ms, "tokens_per_s": tokens / step_ms * 1e3,
        "bound_ms": roof.t_bound * 1e3, "bound_by": roof.bottleneck,
        "t_compute_ms": roof.t_compute * 1e3, "t_memory_ms": roof.t_memory * 1e3,
        "flops": flops, "step_bytes": step_bytes,
        "step_over_bound": step_ms / (roof.t_bound * 1e3),
        "traced_step_busy_ms": busy, "traced_step_events": len(events),
        "traced_step_idle_share": 1 - busy / step_ms, "peak_gb": (peak - base) / 1e9,
        "top_ops": [[name[:90], count, ms] for name, (count, ms) in
                    sorted(by_name.items(), key=lambda kv: -kv[1][1])[:8]]}
    print(f"train {TRAIN_ARCH} full width ({cfg.num_layers} layers, d {cfg.d_model}, vocab "
          f"{cfg.vocab_size}, {n_params / 1e9:.3f} B params, {cfg.dtype}), batch "
          f"{TRAIN_BATCH} x seq {TRAIN_SEQ}: run one {l1} ({wall1:.2f} s); run two "
          f"(resumed at {TRAIN_RESUME_AT}, failure at {TRAIN_FAIL_AT}) {l2} ({wall2:.2f} s, "
          f"stats {stats2}); run two without the failure {clean}")
    print(f"train first loss {l1[0]:.4f}: ln V + d 0.02^2 / 2 = {expected_first:.4f} "
          f"(ln V = {math.log(cfg.vocab_size):.4f}); last loss {l2[-1]:.4f}")
    print(f"train checkpoint {ckpt_bytes / 1e9:.3f} GB; saves {io['save_s']} s, restores "
          f"{io['restore_s']} s; restores {io['restores']}")
    print(f"train compress_grads: losses {lc}; ef after each step {efs}")
    print(f"train step: {step_ms:.2f} ms per step, {row['tokens_per_s']:.0f} tokens/s (host "
          f"clock, {TRAIN_TIMED_STEPS} steps after a warm-up); bound {row['bound_ms']:.3f} ms "
          f"({roof.bottleneck}: 6 N D = {flops:.4e} FLOPs at bf16 "
          f"{peaks.bf16_flops / 1e12:.0f} TFLOP/s = {row['t_compute_ms']:.3f} ms; "
          f"{step_bytes / 1e9:.3f} GB at {peaks.mem_bw / 1e12:.2f} TB/s = "
          f"{row['t_memory_ms']:.3f} ms); step {row['step_over_bound']:.1f}x the bound; traced "
          f"step: device busy {busy:.2f} ms over {len(events)} device events "
          f"({traced_s * 1e3:.1f} ms traced wall), idle share "
          f"{row['traced_step_idle_share']:.3f} of the untraced step; peak device memory "
          f"{row['peak_gb']:.2f} GB above the model's allocation; on {smi}")
    for name, count, ms in row["top_ops"]:
        print(f"  {ms:9.3f} ms {100 * ms / busy:5.1f}% x{count:5d}  {name}")

    reduced = {}
    for arch in configs.ARCH_IDS:
        rcfg = reduced_config(arch)
        cpu = build(rcfg, "cpu").init(torch.Generator().manual_seed(SEED))
        card = build(rcfg)
        card.load_state_dict(cpu.state_dict())
        rdata = SyntheticLMData(DataConfig(rcfg.vocab_size, 32, 2))
        errs = {"loss": 0.0, "params": 0.0, "params_past_tol": 0}
        ok = True
        models = {"cpu": cpu, "card": card}
        steps = {d: make_train_step(rcfg, AdamW(lr=cosine_schedule(
            TRAIN_LR, 0, TRAIN_REDUCED_STEPS)), loss_chunk=16) for d in models}
        states = {d: AdamW().init(dict(m.named_parameters())) for d, m in models.items()}
        for i in range(TRAIN_REDUCED_STEPS):
            b = rdata.batch(i, "cpu")
            if rcfg.frontend != "none":
                b["frontend"] = torch.randn((2, rcfg.frontend_len, rcfg.frontend_dim),
                                            generator=torch.Generator().manual_seed(i))
            losses = {}
            for d, m in models.items():
                states[d], met = steps[d](m, states[d],
                                          {k: v.to(m.device) for k, v in b.items()}, i)
                losses[d] = float(met["loss"])
            errs["loss"] = max(errs["loss"], abs(losses["card"] - losses["cpu"]))
            ok &= abs(losses["card"] - losses["cpu"]) <= TRAIN_CARD_CPU_TOL * abs(losses["cpu"])
        n_all = 0
        for a, b in zip(cpu.state_dict().values(), card.state_dict().values()):
            err = (b.cpu() - a).abs()
            errs["params"] = max(errs["params"], err.max().item())
            errs["params_past_tol"] += int((err > TRAIN_CARD_CPU_TOL).sum())
            n_all += err.numel()
        ok &= (errs["params_past_tol"] <= TRAIN_CARD_CPU_OUTLIERS * n_all
               and errs["params"] <= 2 * TRAIN_LR * TRAIN_REDUCED_STEPS)
        reduced[arch] = {"loss_max_abs_err": errs["loss"], "params_max_abs_err": errs["params"],
                         "params_past_tol": errs["params_past_tol"], "params": n_all}
        print(f"train {rcfg.name} (f32) card against CPU, {TRAIN_REDUCED_STEPS} steps: loss max "
              f"|diff| {errs['loss']:.3e}, updated parameters max |diff| {errs['params']:.3e}, "
              f"{errs['params_past_tol']} of {n_all} past {TRAIN_CARD_CPU_TOL}")
        if not ok:
            raise AssertionError(f"train {rcfg.name}: the card disagrees with the CPU")
    launches = _build.launch_counts()
    print(f"train phase kernel launches: {launches}")

    # the checks, after every number is printed
    if any(launches.values()):
        raise AssertionError("the training path launched FHE kernels")
    if not all(math.isfinite(x) for x in l1 + l2 + clean + lc):
        raise AssertionError("train: a loss is not finite")
    if abs(l1[0] - expected_first) > TRAIN_FIRST_LOSS_TOL:
        raise AssertionError(f"train: first loss {l1[0]} is not within {TRAIN_FIRST_LOSS_TOL} "
                             f"of {expected_first}")
    if not l2[-1] < l1[0]:
        raise AssertionError("train: the loss after the last step is not below the first")
    n_rerun = TRAIN_FAIL_AT - TRAIN_RESUME_AT
    if len(l2) != TRAIN_STEPS - TRAIN_RESUME_AT + n_rerun or \
            stats2["failures"] != 4 or len(clean) != TRAIN_STEPS - TRAIN_RESUME_AT:
        raise AssertionError(f"train: run two took {len(l2)} steps, stats {stats2}")
    diffs = [abs(a - b) for a, b in zip(l2[n_rerun:], clean)] + \
        [abs(a - b) for a, b in zip(l2[:n_rerun], l2[n_rerun:2 * n_rerun])]
    row["restart_max_abs_diff"] = max(diffs)
    if max(diffs) > TRAIN_RESTART_TOL:
        raise AssertionError(f"train: run two's losses differ from the run without the "
                             f"failure by {max(diffs)}")
    if len(io["restores"]) != 3 or not all(r["bitwise"] for r in io["restores"]):
        raise AssertionError(f"train: a restored checkpoint differs from the saved one: "
                             f"{io['restores']}")
    if len(efs) != TRAIN_COMPRESS_STEPS or not all(e["finite"] and e["max_abs"] > 0
                                                   for e in efs):
        raise AssertionError(f"train: compress_grads' error feedback {efs}")
    return {"full": row, "reduced_card_vs_cpu": reduced, "card_cpu_tol": TRAIN_CARD_CPU_TOL,
            "card_cpu_outliers": TRAIN_CARD_CPU_OUTLIERS,
            "restart_tol": TRAIN_RESTART_TOL, "first_loss_tol": TRAIN_FIRST_LOSS_TOL}


def grid_rows_phase(smi: str, device: str = "cuda") -> dict:
    """A fused round past the grid's 65,535 rows: `lut_batch_tables` at
    TEST_PARAMS with GRID_ROWS_B rows (B K level digit rows, more than one
    launch can hold), which must decrypt to its tables, launch each FFT
    once per slice of the batch (`fourstep_fft.row_slices`), and decrypt
    like the reference engine on its first GRID_ROWS_SAMPLE rows."""
    import torch
    from repro_torch.core.engine import TaurusEngine
    from repro_torch.core.params import TEST_PARAMS as p
    from repro_torch.core.pbs import TFHEContext
    from repro_torch.kernels import _build
    from repro_torch.kernels.fourstep_fft import row_slices

    gen = torch.Generator(device=device).manual_seed(SEED)
    ctx = TFHEContext.create(gen, p, device=device)
    eng = TaurusEngine.from_context(ctx, device=device)
    mod = p.plaintext_modulus
    msgs = torch.arange(GRID_ROWS_B, device=device) % mod
    cts = ctx.encrypt(gen, msgs)
    tables = (torch.arange(mod)[None, :] * (torch.arange(GRID_ROWS_B)[:, None] % 3 + 1)
              + torch.arange(GRID_ROWS_B)[:, None]) % mod
    want = tables[torch.arange(GRID_ROWS_B), msgs.cpu()]
    K, J = p.k + 1, (p.k + 1) * p.pbs_level
    plan = {"fft_forward": len(row_slices(GRID_ROWS_B, J)),
            "fft_inverse": len(row_slices(GRID_ROWS_B, K)),
            "external_product_mac": 1, "keyswitch_mac": 1}
    eng.fused_pack
    sync(device)
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    out = eng.lut_batch_tables(cts, tables)
    sync(device)
    wall = time.perf_counter() - t0
    launches = _build.launch_counts()
    got = ctx.decrypt(out).cpu()
    ref = TaurusEngine.from_context(ctx, device=device, kernel_backend="reference")
    s = GRID_ROWS_SAMPLE
    ref_got = ctx.decrypt(ref.lut_batch_tables(cts[:s], tables[:s])).cpu()
    per_round = {k: v if k == "keyswitch_mac" else v * p.n for k, v in plan.items()}
    row = {"params": p.name, "rows": GRID_ROWS_B, "digit_rows": GRID_ROWS_B * J,
           "wall_s": wall, "launches": launches, "launches_planned": per_round,
           "wrong": int((got != want).sum()), "sample_rows": s,
           "sample_matches_reference": bool(torch.equal(ref_got, got[:s]))}
    print(f"grid rows: fused lut_batch_tables at {p.name}, {GRID_ROWS_B} rows = "
          f"{GRID_ROWS_B * J} FFT digit rows (one launch holds 65,535): {wall:.3f} s, "
          f"{row['wrong']} of {GRID_ROWS_B} decrypt wrong, launches {launches} (planned "
          f"{per_round}: {plan['fft_forward']} forward slices per CMux step), reference "
          f"engine on the first {s} rows {'equal' if row['sample_matches_reference'] else 'DIFFERS'}"
          f" on {smi}")
    if row["wrong"] or launches != per_round or not row["sample_matches_reference"]:
        raise AssertionError(f"grid rows: {row}")
    return row


def sync(device) -> None:
    import torch
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def mesh_phase(ctx, smi: str, device: str = "cuda", arch_reduced: bool = False) -> dict:
    """The multi-device paths on one card.

    The engine's cluster mesh: `TaurusEngine.from_context(ctx,
    mesh=shard_mesh((device,) * 4))` (the reference backend, the only one a
    mesh takes) must report 4 clusters and a batch of 48, run a 48-row
    `lut_batch_tables` round that decrypts to its tables, equals the
    one-device reference engine on each cluster's 12 rows bit for bit and
    decrypts as its 48-row round does, and a 45-row round padded by
    3 (telemetry's padded counter 3, `out[:45]` right); the fused backend
    with a mesh must raise `ConfigError`; `build_shards` on a 2-device set
    must give a mesh engine for `reference` and a one-device engine for
    `fused`, each running one round.  Then the LM stack's mesh path at
    world size 1 (one NCCL rank, FileStore under `build/`): MESH_TRAIN_STEPS
    train steps of qwen3-0.6b at full width through DTensor placements
    against the same steps without a process group, `serve` at MESH_SERVE
    tokens both ways, and GPipe over one stage against the sequential run."""
    import shutil
    import tempfile
    import torch
    import torch.distributed as dist
    from repro_torch.core.engine import ConfigError, TaurusEngine
    from repro_torch.kernels import _build
    from repro_torch.launch.mesh import shard_mesh
    from repro_torch.launch.serve import serve
    from repro_torch.launch.train import train
    from repro_torch.models.pipeline import make_pipelined_fwd
    from repro_torch.obs import Telemetry
    from repro_torch.runtime.fault import StepRunner
    from repro_torch.serve import build_shards

    p = ctx.params
    dev = torch.device(device)
    res = {}
    gen = torch.Generator(device=device).manual_seed(SEED + 1)
    mod = p.plaintext_modulus
    rows = MESH_CLUSTERS * 12
    msgs = torch.randint(0, mod, (rows,), generator=gen, device=device)
    cts = ctx.encrypt(gen, msgs)
    tables = torch.stack([torch.randperm(mod, generator=torch.Generator().manual_seed(SEED + r))
                          for r in range(rows)])
    want = tables[torch.arange(rows), msgs.cpu()]

    _build.reset_launch_counts()
    sync(device)
    base = torch.cuda.memory_allocated() if dev.type == "cuda" else 0
    mesh_eng = TaurusEngine.from_context(ctx, mesh=shard_mesh((dev,) * MESH_CLUSTERS))
    added = (torch.cuda.memory_allocated() if dev.type == "cuda" else 0) - base
    one = TaurusEngine.from_context(ctx, device=device, kernel_backend="reference")
    if (mesh_eng.n_clusters, mesh_eng.batch_size) != (MESH_CLUSTERS, 12 * MESH_CLUSTERS):
        raise AssertionError(f"mesh engine: {mesh_eng.n_clusters} clusters, batch "
                             f"{mesh_eng.batch_size}")

    def timed(run):
        sync(device)
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out = run()
        sync(device)
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() if dev.type == "cuda" else 0
        return out, wall, peak

    out_m, wall_m, peak_m = timed(lambda: mesh_eng.lut_batch_tables(cts, tables))
    out_1, wall_1, peak_1 = timed(lambda: one.lut_batch_tables(cts, tables))
    # the one-device engine on each cluster's rows: the same batches
    out_c, wall_c, _ = timed(lambda: torch.cat([
        one.lut_batch_tables(cts[i:i + 12], tables[i:i + 12]) for i in range(0, rows, 12)]))
    _, _, events_m, _, busy_m = trace_device(lambda: mesh_eng.lut_batch_tables(cts, tables),
                                             "profile_mesh_round.json")
    got = ctx.decrypt(out_m).cpu()
    res["round48"] = {"rows": rows, "clusters": mesh_eng.n_clusters,
                      "batch_size": mesh_eng.batch_size, "wall_s": wall_m,
                      "one_device_wall_s": wall_1, "busy_ms": busy_m,
                      "device_events": len(events_m), "idle_share": 1 - busy_m / (wall_m * 1e3),
                      "peak_gb": peak_m / 1e9, "one_device_peak_gb": peak_1 / 1e9,
                      "key_copies": len(mesh_eng._keys), "engine_alloc_bytes": added,
                      "one_device_by_cluster_wall_s": wall_c,
                      "wrong": int((got != want).sum()),
                      "bit_identical": bool(torch.equal(out_m, out_c)),
                      "decrypts_as_one_device_48": bool(torch.equal(
                          ctx.decrypt(out_1).cpu(), got)),
                      "words_differing_48": int((out_m != out_1).sum()),
                      "words": out_m.numel()}
    tel = Telemetry()
    mesh_eng.telemetry = tel
    pad_rows = rows - 3
    out_p, wall_p, _ = timed(lambda: mesh_eng.lut_batch_tables(cts[:pad_rows], tables[:pad_rows]))
    mesh_eng.telemetry = None
    c = tel.snapshot()["counters"]
    res["round45"] = {"rows": pad_rows, "wall_s": wall_p, "pbs_rows": c["engine.pbs_rows"],
                      "padded": c["engine.pbs_rows_padded"], "out_rows": int(out_p.shape[0]),
                      "wrong": int((ctx.decrypt(out_p).cpu() != want[:pad_rows]).sum())}
    mesh_launches = _build.launch_counts()
    try:
        TaurusEngine.from_context(ctx, mesh=shard_mesh((dev,) * 2), kernel_backend="fused")
        refused = False
    except ConfigError:
        refused = True
    r = res["round48"]
    print(f"mesh engine ({MESH_CLUSTERS} clusters on {device}, reference backend): n_clusters "
          f"{r['clusters']}, batch_size {r['batch_size']}; {rows}-row round {wall_m:.3f} s "
          f"(device busy {busy_m:.1f} ms over {len(events_m)} device events, idle share "
          f"{r['idle_share']:.3f}), one-device reference round {wall_1:.3f} s; "
          f"{r['wrong']} of {rows} decrypt wrong; bit-identical to the one-device engine on "
          f"each cluster's 12 rows ({wall_c:.3f} s): {r['bit_identical']}; against its one "
          f"{rows}-row round: decrypts equal {r['decrypts_as_one_device_48']}, "
          f"{r['words_differing_48']} of {r['words']} words differ (the card's FFT and "
          f"einsum pick their kernels by batch size: 12 rows round otherwise than 48); peak memory {peak_m / 1e9:.2f} GB (one device "
          f"{peak_1 / 1e9:.2f}); key copies {r['key_copies']}, the mesh engine allocated "
          f"{added} bytes; {pad_rows}-row round {wall_p:.3f} s, pbs_rows {res['round45']['pbs_rows']}"
          f", padded {res['round45']['padded']}, {res['round45']['wrong']} wrong; launches "
          f"{mesh_launches}; fused + mesh raises ConfigError: {refused} on {smi}")

    _build.reset_launch_counts()
    shards = {}
    for kb in ("reference", "fused"):
        eng = build_shards(ctx, n_shards=1, device_sets=[(dev,) * 2], kernel_backend=kb)[0].engine
        before = _build.launch_counts()
        o, wall, _ = timed(lambda: eng.lut_batch_tables(cts[:12], tables[:12]))
        after = _build.launch_counts()
        shards[kb] = {"clusters": eng.n_clusters, "mesh": eng.mesh is not None,
                      "wall_s": wall, "launches": {k: after[k] - before[k] for k in after},
                      "wrong": int((ctx.decrypt(o).cpu() != want[:12]).sum())}
        print(f"build_shards on a 2-device set, {kb}: mesh engine {eng.mesh is not None}, "
              f"{eng.n_clusters} clusters; 12-row round {wall:.3f} s, "
              f"{shards[kb]['wrong']} wrong, launches {shards[kb]['launches']}")
    res["shards"] = shards
    res["launches"] = {"mesh_round": mesh_launches, "fused_shard": shards["fused"]["launches"]}

    # -- the LM stack's mesh path at world size 1 ------------------------------
    durations = []
    run_step = StepRunner.run

    def timed_run(self, *a, **kw):
        t0 = time.perf_counter()
        out = run_step(self, *a, **kw)
        durations.append(time.perf_counter() - t0)
        return out

    kw = dict(reduced=arch_reduced, batch=TRAIN_BATCH, seq=TRAIN_SEQ, log_every=100,
              device=device)
    lm = {}
    StepRunner.run = timed_run
    try:
        plain_losses, _ = train(TRAIN_ARCH, steps=MESH_TRAIN_STEPS, **kw)
        plain_s, durations[:] = list(durations), []
        plain_serve = serve(TRAIN_ARCH, reduced=arch_reduced, device=device, **MESH_SERVE)
        store = tempfile.mkdtemp(dir=ROOT / "build", prefix="mesh_store_")
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                                store=dist.FileStore(os.path.join(store, "store"), 1),
                                rank=0, world_size=1)
        try:
            mesh_losses, _ = train(TRAIN_ARCH, steps=MESH_TRAIN_STEPS, model_parallel=1, **kw)
            mesh_s = list(durations)
            mesh_serve = serve(TRAIN_ARCH, reduced=arch_reduced, device=device,
                               model_parallel=1, **MESH_SERVE)
            from torch.distributed.device_mesh import init_device_mesh
            pod = init_device_mesh(dev.type, (1,), mesh_dim_names=("pod",))
            g = torch.Generator().manual_seed(SEED)
            W = (torch.randn((1, 64, 64), generator=g) / 8).to(device)
            x = torch.randn((16, 8, 64), generator=g).to(device)
            stage = lambda w, h: torch.tanh(h @ w)
            piped = make_pipelined_fwd(stage, pod, n_micro=8)(W[:, None], x)
            pipe_err = (piped - stage(W[0], x)).abs().max().item()
        finally:
            dist.destroy_process_group()
            shutil.rmtree(store, ignore_errors=True)
    finally:
        StepRunner.run = run_step
    gap = max(abs(a - b) for a, b in zip(mesh_losses, plain_losses))
    logit_gap = (mesh_serve.logits.float() - plain_serve.logits.float()).abs().max().item()
    steady = lambda s: statistics.median(s[1:]) * 1e3
    lm = {"arch": TRAIN_ARCH, "reduced": arch_reduced, "batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
          "plain_losses": plain_losses, "mesh_losses": mesh_losses, "loss_gap": gap,
          "plain_step_s": plain_s, "mesh_step_s": mesh_s,
          "plain_ms_per_step": steady(plain_s), "mesh_ms_per_step": steady(mesh_s),
          "serve_tokens_equal": bool((mesh_serve.tokens == plain_serve.tokens).all()),
          "serve_logit_gap": logit_gap, "serve_decode_s": {
              "plain": plain_serve.decode_s, "mesh": mesh_serve.decode_s},
          "pipeline_err": pipe_err}
    res["lm"] = lm
    print(f"mesh LM ({TRAIN_ARCH}, world size 1, DTensor placements): losses {mesh_losses} "
          f"against {plain_losses} without a process group, largest gap {gap:.3e}; ms per "
          f"step (median of steps 2-{MESH_TRAIN_STEPS}) {lm['mesh_ms_per_step']:.1f} against "
          f"{lm['plain_ms_per_step']:.1f} (each step's s: mesh {mesh_s}, plain {plain_s}); "
          f"serve {MESH_SERVE}: tokens equal {lm['serve_tokens_equal']}, logits max |diff| "
          f"{logit_gap:.3e}, decode {mesh_serve.decode_s:.2f} s against "
          f"{plain_serve.decode_s:.2f} s; GPipe at one stage max |diff| {pipe_err:.3e} on {smi}")

    # the checks, after every number is printed
    bad = []
    if r["wrong"] or not r["bit_identical"] or not r["decrypts_as_one_device_48"] or \
            r["key_copies"] != 1:
        bad.append(f"the {rows}-row mesh round: {r}")
    if res["round45"]["wrong"] or res["round45"]["padded"] != 3 or \
            res["round45"]["pbs_rows"] != rows or res["round45"]["out_rows"] != pad_rows:
        bad.append(f"the padded mesh round: {res['round45']}")
    if any(mesh_launches.values()):
        bad.append(f"the reference mesh rounds launched kernels: {mesh_launches}")
    if not refused:
        bad.append("fused + mesh did not raise ConfigError")
    if not (shards["reference"]["mesh"] and shards["reference"]["clusters"] == 2
            and not shards["fused"]["mesh"] and not shards["reference"]["wrong"]
            and not shards["fused"]["wrong"]
            and not any(shards["reference"]["launches"].values())
            and shards["fused"]["launches"] == {"keyswitch_mac": 1, "fft_forward": p.n,
                                                "fft_inverse": p.n,
                                                "external_product_mac": p.n}):
        bad.append(f"build_shards: {shards}")
    if gap > MESH_LOSS_TOL * max(abs(x) for x in plain_losses) or \
            not all(math.isfinite(x) for x in mesh_losses):
        bad.append(f"mesh train losses {mesh_losses} against {plain_losses}")
    if not lm["serve_tokens_equal"] or pipe_err > GPIPE_TOL:
        bad.append(f"mesh serve tokens equal {lm['serve_tokens_equal']}, GPipe {pipe_err}")
    if bad:
        raise AssertionError("mesh phase: " + "; ".join(bad))
    return res


def kernels_at_rows(cts, pack, gen, peaks: tuple, smi: str) -> dict:
    """Each kernel on the shapes a round of `cts.shape[0]` rows gives it,
    against its plain version, timed one call at a time and back to
    back, beside its bound and, for the MAC, `torch.einsum` on the same
    inputs.  Returns {row name: measurements}."""
    import torch
    from repro_torch.core import decompose as dec, torus
    from repro_torch.kernels import external_product as ep, fourstep_fft as ff
    from repro_torch.kernels import keyswitch as ks
    mem_rate, fp64_rate, int8_rate = peaks[:3]
    p = pack.params
    R, K, M = cts.shape[0], p.k + 1, p.N // 2
    J = K * p.pbs_level
    digits = dec.decompose(cts[:, :-1], p.ks_base_log, p.ks_level)
    digits = digits.reshape(R, -1).to(torch.int8).contiguous()
    limbs = pack.ksk_limbs
    S, T = digits.shape[1], limbs.shape[0] // 8
    acc = torus.random_torus(gen, (R, K, p.N), device=cts.device)
    shifts = torch.randint(0, 2 * p.N, (R,), generator=gen, device=cts.device)
    dig = ff.fft_forward_digits(acc, shifts, p.pbs_base_log, p.pbs_level)
    bsk_i = pack.bsk_planes[0]
    mac = ep.external_product_mac(dig, bsk_i)
    d_c, w_c = torch.complex(dig[:, 0], dig[:, 1]), torch.complex(bsk_i[0], bsk_i[1])
    x_scale = ff.fft_inverse_plain(mac.transpose(1, 2).reshape(R * K, 2, M)).abs().max().item()
    fft_flops = 5 * M * (M.bit_length() - 1)
    # the plain transforms on the round's digit rows and its MAC output rows
    x = torch.randint(-(1 << (p.pbs_base_log - 1)), 1 << (p.pbs_base_log - 1),
                      (R * J, p.N), generator=gen, device=cts.device).to(torch.float64)
    u = torch.complex(x[:, :M], x[:, M:]) * ff.core_fft.twist(p.N, x.device)
    planes = mac.transpose(1, 2).reshape(R * K, 2, M).contiguous()
    z = torch.complex(planes[:, 0], planes[:, 1])
    # (run, plain, library call, tolerance, bytes moved, operations, their
    # peak rate): the keyswitch's operations are int8 tensor-core MACs x 2
    cases = {
        "keyswitch_mac": (lambda: ks.keyswitch_mac(digits, limbs),
                          lambda: ks.keyswitch_mac_plain(digits, limbs), None, "exact",
                          nbytes(digits, limbs) + R * T * 8, 2 * R * S * 8 * T, int8_rate),
        "fft_forward_digits": (
            lambda: ff.fft_forward_digits(acc, shifts, p.pbs_base_log, p.pbs_level),
            lambda: ff.fft_forward_digits_plain(acc, shifts, p.pbs_base_log, p.pbs_level),
            None, 1e-12, nbytes(acc, shifts, dig), fft_flops * R * J, fp64_rate),
        "external_product_mac": (lambda: ep.external_product_mac(dig, bsk_i),
                                 lambda: ep.external_product_mac_plain(dig, bsk_i),
                                 lambda: torch.einsum("bjf,jkf->bkf", d_c, w_c), 1e-9,
                                 nbytes(dig, bsk_i, mac), 8 * R * J * K * M, fp64_rate),
        "fft_inverse_torus": (lambda: ff.fft_inverse_torus(mac, acc),
                              lambda: ff.fft_inverse_torus_plain(mac, acc), None, "torus",
                              nbytes(mac, acc, acc), fft_flops * R * K, fp64_rate),
        "fft_forward": (lambda: ff.fft_forward(x), lambda: ff.fft_forward_plain(x),
                        lambda: torch.fft.fft(u, dim=-1), 1e-12, 2 * nbytes(x),
                        fft_flops * R * J, fp64_rate),
        "fft_inverse": (lambda: ff.fft_inverse(planes), lambda: ff.fft_inverse_plain(planes),
                        lambda: torch.fft.ifft(z, dim=-1), 1e-12, 2 * nbytes(planes),
                        fft_flops * R * K, fp64_rate),
    }
    out = {}
    for name, (run, plain, library, tol, moved, ops, rate) in cases.items():
        got, want = run(), plain()
        torch.cuda.synchronize()
        d = (got - want).abs().max().item()
        if tol == "exact":
            ok = torch.equal(got, want)
        elif tol == "torus":
            ok = d <= 1e-12 * x_scale + 1
        else:
            ok = d <= tol * want.abs().max().item()
        del want
        m = timed_kernel(run, None, library, moved, ops, rate, mem_rate, 5, 10)
        text = m.pop("text")
        out[name] = {"rows": R, "max_abs_err": d, **m}
        print(f"phase {name} at {R} rows: max_abs_err {d:.3e} ({'ok' if ok else 'FAILED'}, "
              f"limit {tol}), {text} on {smi}")
        if not ok:
            raise AssertionError(f"{name} at {R} rows disagrees with its plain version")
    return out


OPS_FFT_TOL = 2e-5      # of the spectrum scale (tests/test_kernels.py)
OPS_MAC_ATOL = 1e-2
# the int8 limb products of one int32 digit and one 64-bit key word that
# reach bits below 2^64: digit i (weight 2^(8i)) meets key bytes l < 8 - i
INT32_LIMB_PRODUCTS = sum(8 - i for i in range(5))


def ops_phase(ctx, gen, peaks: tuple, smi: str) -> dict:
    """`repro_torch.kernels.ops`, the reference's public wrappers, on the
    card: the f32 transforms and MAC and the keyswitch on int32 digits.

    First the reference tests' shapes (FFT N in {256, 2048, 8192, 65536}
    at 1 and 3 rows, with the round trip; the MAC (B, 2, 4, 512) x (2, 4,
    2, 512) at B = 1 and 12; the keyswitch's three (B, S, T) and its
    extreme-digit row), then gpt2's shapes (N = 32,768, the digit rows of
    B = 12 and 288 ciphertexts, the key's S and T): each f32 kernel within
    OPS_FFT_TOL of the spectrum scale of the f64 transform (the MAC within
    OPS_MAC_ATOL of the f64 product), and of its complex64 plain version,
    the keyswitch bit for bit against its plain version.  The four
    wrappers' launches are counted over one call each at B = 12, and each
    is timed at both row counts beside its bound (bytes at the memory rate:
    f32 halves them), its plain version, the complex64 `torch.fft` /
    `einsum` call and the f64 kernel at the same shape.  Returns the four
    {"kernels": ...} rows and the checks."""
    import torch
    from repro_torch.kernels import _build, external_product as ep, fourstep_fft as ff
    from repro_torch.kernels import keyswitch as ks, ops
    mem_rate, fp64_rate, int8_rate = peaks[:3]
    # the data sheets' FP32 rate (CUDA cores) equals their FP64 tensor-core
    # rate on every H100 part in `roofline.PEAKS`
    fp32_rate = fp64_rate
    p = ctx.params
    f32 = torch.float32
    checks = []

    def fft_case(x):
        """(f32 spectrum error, complex64 plain error) over the f64
        spectrum's scale, and the round trip's largest error."""
        spec = ops.negacyclic_fft(x)
        want = ff.fft_forward_plain(x.double())
        scale = want.abs().max().item() + 1.0
        err = (spec.double() - want).abs().max().item() / scale
        err_plain = (spec - ff.fft_forward_plain(x, f32)).abs().max().item() / scale
        back = ops.negacyclic_ifft(spec)
        err_inv = (back - ff.fft_inverse_plain(spec, f32)).abs().max().item() / (
            x.abs().max().item() + 1.0)
        trip = (back - x).abs().max().item()
        return err, err_plain, err_inv, trip

    for N in (256, 2048, 8192, 65536):
        for rows in (1, 3):
            x = torch.randint(-(1 << 7), 1 << 7, (rows, N), generator=gen,
                              device="cuda").to(f32)
            err, err_plain, err_inv, trip = fft_case(x)
            ok = max(err, err_plain, err_inv) <= OPS_FFT_TOL and trip <= 0.25 * N ** 0.5 / 8
            checks.append({"what": f"fft N={N} B={rows}", "err": err, "err_plain": err_plain,
                           "err_inverse": err_inv, "roundtrip": trip, "ok": ok})
    for rows in (1, 12):
        dig = torch.randn((rows, 2, 4, 512), generator=gen, device="cuda") * 100
        bsk = torch.randn((2, 4, 2, 512), generator=gen, device="cuda")
        got = ops.bru_mac(dig, bsk).double()
        errs = [(got - w.double()).abs().max().item() for w in (
            ep.external_product_mac_plain(dig.double(), bsk.double()),
            ep.external_product_mac_plain(dig, bsk, f32))]
        checks.append({"what": f"mac B={rows} J=4 K=2 F=512", "err": errs[0],
                       "err_plain": errs[1], "ok": max(errs) <= OPS_MAC_ATOL})
    ks_cases = [(1, 128, 65), (4, 1024, 513), (2, 4096, 257)]
    for rows, S, T in ks_cases:
        d = torch.randint(-(1 << 31), (1 << 31) - 1, (rows, S), generator=gen,
                          device="cuda").to(torch.int32)
        k = torch.randint(-(1 << 62), 1 << 62, (S, T), generator=gen, device="cuda") * 3
        got = ops.lpu_keyswitch_mac(d, k)
        checks.append({"what": f"keyswitch B={rows} S={S} T={T}",
                       "ok": torch.equal(got, ks.keyswitch_mac_int32_plain(d, k))})
    d = torch.tensor([[-(1 << 31), (1 << 31) - 1, -1, 1, 0, 7, -7, 12345]],
                     dtype=torch.int32, device="cuda")
    k = torch.randint(-(1 << 62), 1 << 62, (8, 33), generator=gen, device="cuda") * 3
    got = ops.lpu_keyswitch_mac(d, k, block_s=8)
    checks.append({"what": "keyswitch extreme digits", "ok": torch.equal(
        got, ks.keyswitch_mac_int32_plain(d, k)) and torch.equal(
        got, (d.to(torch.int64)[:, :, None] * k[None]).sum(1))})
    for c in checks:
        print(f"ops {c['what']}: " + ", ".join(f"{k_} {v:.3e}" for k_, v in c.items()
                                                if isinstance(v, float)) +
              f" ({'ok' if c['ok'] else 'FAILED'})")
    if not all(c["ok"] for c in checks):
        raise AssertionError("an ops wrapper disagrees at the reference tests' shapes")

    # gpt2's shapes: the digit rows of B and 288 ciphertexts, the key's S x T
    K, M = p.k + 1, p.N // 2
    J = K * p.pbs_level
    ksk = ctx.ksk.reshape(-1, ctx.ksk.shape[-1])
    S, T = ksk.shape
    fft_flops = 5 * M * (M.bit_length() - 1)
    rows_out = {}
    launches = None
    for R in (B, 288):
        x = torch.randint(-(1 << 7), 1 << 7, (R * J, p.N), generator=gen, device="cuda").to(f32)
        x64 = x.double()
        u = torch.complex(x[:, :M], x[:, M:]) * ff.core_fft.twist(p.N, x.device).to(
            torch.complex64)
        spec = ops.negacyclic_fft(x)
        spec64 = spec.double()
        zc = torch.complex(spec[:, 0], spec[:, 1])
        dig = torch.randn((R, 2, J, M), generator=gen, device="cuda") * 100
        bsk = torch.randn((2, J, K, M), generator=gen, device="cuda")
        dig64, bsk64 = dig.double(), bsk.double()
        d_c, w_c = torch.complex(dig[:, 0], dig[:, 1]), torch.complex(bsk[0], bsk[1])
        mac = ops.bru_mac(dig, bsk)
        digits = torch.randint(-(1 << 31), (1 << 31) - 1, (R, S), generator=gen,
                               device="cuda").to(torch.int32)
        if R == B:       # the ops path's launches: one call of each wrapper
            torch.cuda.synchronize()
            _build.reset_launch_counts()
            ops.negacyclic_fft(x)
            ops.negacyclic_ifft(spec)
            ops.bru_mac(dig, bsk)
            ops.lpu_keyswitch_mac(digits, ksk)
            torch.cuda.synchronize()
            launches = _build.launch_counts()
            print(f"ops launches, one call of each wrapper at B={B}: {launches}")
            if min(launches.values()) < 1:
                raise AssertionError(f"an ops wrapper launched no kernel: {launches}")

        def spec_err(got, want):
            return (got.double() - want.double()).abs().max().item() / (
                want.abs().max().item() + 1.0)

        cases = {
            # name: (TPU kernel, run, plain, f64 kernel, library, error check, bytes, ops, rate)
            "fft_forward[f32]": (
                "src/repro/kernels/fourstep_fft.py:119", lambda: ops.negacyclic_fft(x),
                lambda: ff.fft_forward_plain(x, f32), lambda: ff.fft_forward(x64),
                lambda: torch.fft.fft(u, dim=-1),
                lambda got: (spec_err(got, ff.fft_forward_plain(x64)),
                             spec_err(got, ff.fft_forward_plain(x, f32)), OPS_FFT_TOL),
                2 * nbytes(x), fft_flops * R * J, fp32_rate),
            "fft_inverse[f32]": (
                "src/repro/kernels/fourstep_fft.py:139", lambda: ops.negacyclic_ifft(spec),
                lambda: ff.fft_inverse_plain(spec, f32), lambda: ff.fft_inverse(spec64),
                lambda: torch.fft.ifft(zc, dim=-1),
                lambda got: (spec_err(got, ff.fft_inverse_plain(spec64)),
                             spec_err(got, ff.fft_inverse_plain(spec, f32)), OPS_FFT_TOL),
                2 * nbytes(spec), fft_flops * R * J, fp32_rate),
            "external_product_mac[f32]": (
                "src/repro/kernels/external_product.py:44", lambda: ops.bru_mac(dig, bsk),
                lambda: ep.external_product_mac_plain(dig, bsk, f32),
                lambda: ep.external_product_mac(dig64, bsk64),
                lambda: torch.einsum("bjf,jkf->bkf", d_c, w_c),
                lambda got: ((got.double() - ep.external_product_mac_plain(dig64, bsk64))
                             .abs().max().item(),
                             (got - ep.external_product_mac_plain(dig, bsk, f32))
                             .abs().max().item(), OPS_MAC_ATOL),
                nbytes(dig, bsk, mac), 8 * R * J * K * M, fp32_rate),
            "lpu_keyswitch_mac[int32]": (
                "src/repro/kernels/keyswitch.py:91", lambda: ops.lpu_keyswitch_mac(digits, ksk),
                lambda: ks.keyswitch_mac_int32_plain(digits, ksk), None, None,
                lambda got: (0.0 if torch.equal(got, ks.keyswitch_mac_int32_plain(digits, ksk))
                             else float("inf"), 0.0, 0.0),
                nbytes(digits, ksk) + R * T * 8, 2 * R * S * T * INT32_LIMB_PRODUCTS,
                int8_rate),
        }
        # the int32 wrapper builds the key's limb operand on every call: the
        # kernel alone on the prepared operands is timed beside it
        d8, limbs = ks.split_int32(digits), ks.ksk_limbs(ksk)
        ks_kernel_ms = cuda_ms(lambda: ks.keyswitch_mac(d8, limbs), 5)
        del d8, limbs
        for name, (replaces, run, plain, f64_run, library, check, moved, n_ops,
                   rate) in cases.items():
            got = run()
            torch.cuda.synchronize()
            err, err_plain, tol = check(got)
            ok = err <= tol and err_plain <= tol
            del got
            reps, b2b = (5, 10) if R > B or name.startswith("lpu") else (REPEATS, B2B_LAUNCHES)
            m = timed_kernel(run, plain, library, moved, n_ops, rate, mem_rate, reps, b2b, 3)
            m.update(rows=R, max_abs_err=err, err_plain=err_plain,
                     f64_ms=cuda_ms(f64_run, reps) if f64_run else None)
            if name.startswith("lpu"):
                m["kernel_only_ms"] = ks_kernel_ms
            print(f"ops {name} at {R} rows: error {err:.3e} against f64 / exact, "
                  f"{err_plain:.3e} against its plain version ({'ok' if ok else 'FAILED'}, "
                  f"limit {tol}), {m.pop('text')}, f64 kernel ms {m['f64_ms']}"
                  + (f", the kernel alone {ks_kernel_ms:.4f} ms" if name.startswith("lpu")
                     else "") + f" on {smi}")
            if not ok:
                raise AssertionError(f"ops {name} at {R} rows disagrees: {err}, {err_plain}")
            if R == B:
                rows_out[name] = {"name": name, "route": "cuda", "source": (
                    "src/repro_torch/kernels/csrc/keyswitch.cu" if name.startswith("lpu")
                    else "src/repro_torch/kernels/csrc/fft.cu" if name.startswith("fft")
                    else "src/repro_torch/kernels/csrc/external_product.cu"),
                    "replaces": replaces, "launches": None, **m}
            else:
                rows_out[name].update({f"{k_}_288": m[k_] for k_ in (
                    "max_abs_err", "ms", "ms_b2b", "plain_ms", "f64_ms", "library_ms",
                    "bound_ms", "bound_by", "kernel_only_ms") if k_ in m})
        del x, x64, u, spec, spec64, zc, dig, bsk, dig64, bsk64, d_c, w_c, mac, digits
        torch.cuda.empty_cache()
    key = {"fft_forward[f32]": "fft_forward", "fft_inverse[f32]": "fft_inverse",
           "external_product_mac[f32]": "external_product_mac",
           "lpu_keyswitch_mac[int32]": "keyswitch_mac"}
    for name, row in rows_out.items():
        row["launches"] = launches[key[name]]
    # the int32 keyswitch's operands are the phase's own: the main path's
    # peak memory starts after them
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    return {"rows": list(rows_out.values()), "checks": checks, "launches": launches}


# the dry run's cells on the card's machine: (arch, shape, multi_pod)
DRYRUN_CELLS = (("qwen3-0.6b", "train_4k", False), ("qwen3-0.6b", "train_4k", True),
                ("qwen3-0.6b", "prefill_32k", False), ("qwen3-0.6b", "prefill_32k", True),
                ("qwen3-0.6b", "decode_32k", False), ("qwen3-0.6b", "decode_32k", True),
                ("deepseek-coder-33b", "train_4k", True), ("qwen2-moe-a2.7b", "train_4k", False))
DRYRUN_TIMEOUT_S = 600
DRYRUN_SCRIPT = """
import json, sys
from repro_torch.launch import dryrun
cells = json.loads(sys.argv[1])
print(json.dumps([dryrun.run_cell(a, s, multi_pod=m, verbose=False) for a, s, m in cells]))
"""


def dryrun_phase(smi: str) -> dict:
    """`repro_torch.launch.dryrun` on DRYRUN_CELLS, at the published widths
    on fake (16, 16) and (2, 16, 16) meshes of the card's device type, in
    a process of its own (the dry run holds a fake process group): every
    cell must run, its useful share of the counted FLOPs lie in (0, 1.05],
    and qwen3-0.6b's FLOPs x chips agree on the two meshes.  The numbers
    are analytic counts at the card's data-sheet peaks, not measurements."""
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", DRYRUN_SCRIPT, json.dumps(DRYRUN_CELLS)],
                          cwd=ROOT, env={**os.environ, "PYTHONPATH": str(SRC)},
                          capture_output=True, text=True, timeout=DRYRUN_TIMEOUT_S)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"dry run failed:\n{proc.stderr[-4000:]}")
    records = json.loads(proc.stdout.strip().splitlines()[-1])
    for r in records:
        print(f"dryrun {r['arch']} {r['shape']} {r['mesh']}: flops/dev {r['flops']:.4e}, "
              f"useful {r['flops_ratio']:.3f}, Tc {r['t_compute_s']:.3e} s, Tm "
              f"{r['t_memory_s']:.3e} s (major {r['t_memory_major_s']:.3e}), Tcoll "
              f"{r['t_collective_s']:.3e} s -> {r['bottleneck']}, args/dev "
              f"{r['arg_bytes'] / 2 ** 30:.2f} GiB, temp/dev {r['temp_bytes'] / 2 ** 30:.2f} GiB, "
              f"counted in {r['lower_s'] + r['compile_s']:.1f} s (analytic, peaks of {smi})")
        if not 0 < r["flops_ratio"] <= 1.05:
            raise AssertionError(f"dry run {r['arch']} {r['shape']} {r['mesh']}: useful "
                                 f"share {r['flops_ratio']}")
    by = {(r["arch"], r["shape"], r["chips"]): r for r in records}
    for (arch, shape, chips), r in by.items():
        other = by.get((arch, shape, 512))
        if chips == 256 and other is not None:
            a, b = r["flops"] * 256, other["flops"] * 512
            if abs(a - b) > 1e-9 * a:
                raise AssertionError(f"dry run {arch} {shape}: FLOPs x chips {a:.6e} on "
                                     f"16x16, {b:.6e} on 2x16x16")
    print(f"dryrun: {len(records)} cells in {wall:.1f} s")
    return {"records": records, "wall_s": wall}


EXAMPLES = ("quickstart", "encrypted_int32", "fhe_gpt2", "serve_requests", "sim_scenario",
            "trace_serve")
EXAMPLES_TIMEOUT_S = 600


def examples_phase(smi: str) -> dict:
    """The six demos (`python -m repro_torch.examples.<name>`) on the card,
    side by side, one process each: each must exit 0 and print at least
    one `got (expect want)` line, every got equal to its want, and
    trace_serve's Chrome trace must validate."""
    from repro_torch.examples import checked_lines
    from repro_torch.obs import validate_chrome_trace
    out = ROOT / "build" / "examples"
    out.mkdir(parents=True, exist_ok=True)
    extra = {"sim_scenario": ["--out", str(out / "sim_scenario_report.json")],
             "trace_serve": ["--out", str(out / "trace_serve.json")]}
    env = {**os.environ, "PYTHONPATH": str(SRC)}
    t0 = time.perf_counter()
    procs = {name: (time.perf_counter(), subprocess.Popen(
        [sys.executable, "-m", f"repro_torch.examples.{name}", *extra.get(name, [])],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
        for name in EXAMPLES}
    results = {}
    for name, (start, proc) in procs.items():
        try:
            stdout, stderr = proc.communicate(timeout=EXAMPLES_TIMEOUT_S)
        finally:
            if proc.poll() is None:
                proc.kill()
        wall = time.perf_counter() - start
        checks = checked_lines(stdout)
        lines = [ln for ln, _, _ in checks]
        ok = proc.returncode == 0 and bool(checks) and all(g == w for _, g, w in checks)
        results[name] = {"rc": proc.returncode, "wall_s": wall, "lines": len(lines), "ok": ok}
        for ln in lines:
            print(f"example {name}: {ln.strip()}")
        print(f"example {name}: exit {proc.returncode}, {len(lines)} got/expect lines, "
              f"{'all equal' if ok else 'FAILED'}, wall {wall:.1f} s on {smi}")
        if not ok:
            raise AssertionError(f"example {name} failed:\n{stdout[-2000:]}\n{stderr[-3000:]}")
    events = validate_chrome_trace(str(out / "trace_serve.json"))
    results["trace_serve"]["trace_events"] = events
    print(f"examples: all six in {time.perf_counter() - t0:.1f} s side by side; "
          f"trace_serve's trace validates ({events} events)")
    return results


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        print(f"chip_smoke: the port is not under {SRC}", file=sys.stderr)
        return 1
    sys.path.insert(0, str(SRC))
    from repro_torch.core import decompose as dec, torus
    from repro_torch.core.engine import TaurusEngine
    from repro_torch.core.params import PAPER_PARAMS
    from repro_torch.core.pbs import TFHEContext
    from repro_torch.kernels import _build, external_product as ep, fourstep_fft as ff
    from repro_torch.kernels import keyswitch as ks
    from repro_torch.kernels.cmux_accuracy import step_errors
    from repro_torch.launch.roofline import card_peaks

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    card = torch.cuda.get_device_name(0)
    peaks = card_peaks(card)
    mem_rate = peaks[0]
    print(f"card: {smi}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}")

    t0 = time.perf_counter()
    _build.build_all()
    print(f"kernel build: {time.perf_counter() - t0:.2f} s")
    for lib, log in _build.build_logs().items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {lib}: {line.strip()}")

    # -- keygen on the card -------------------------------------------------
    p = PAPER_PARAMS["gpt2"]
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    t0 = time.perf_counter()
    ctx = TFHEContext.create(gen, p, device="cuda")
    torch.cuda.synchronize()
    print(f"keygen {p.name}: n={p.n} N={p.N} k={p.k} width={p.width} "
          f"{time.perf_counter() - t0:.2f} s, ksk {nbytes(ctx.ksk) / 1e9:.3f} GB, "
          f"bsk_f {nbytes(ctx.bsk_f) / 1e9:.3f} GB")
    engine = TaurusEngine.from_context(ctx)               # fused, on the card
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pack = engine.fused_pack           # built at first use: each engine's first round
    torch.cuda.synchronize()
    print(f"resident pack built in {(time.perf_counter() - t0) * 1e3:.2f} ms: bsk planes "
          f"{nbytes(pack.bsk_planes) / 1e9:.3f} GB, ksk limb operand "
          f"{tuple(pack.ksk_limbs.shape)} {nbytes(pack.ksk_limbs) / 1e9:.3f} GB; device "
          f"memory allocated {torch.cuda.memory_allocated() / 1e9:.2f} GB, peak "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB on {smi}")
    msgs = (torch.arange(B, device="cuda") * 11 + 3) % p.plaintext_modulus
    cts = ctx.encrypt(gen, msgs)
    assert torch.equal(ctx.decrypt(cts), msgs), "fresh encryptions do not decrypt"

    # -- each kernel against its plain version at the main path's shapes ------
    kernels = []

    def phase(name, route_src, replaces, run, plain, library, err, tol,
              moved, ops, rate):
        got, want = run(), plain()
        torch.cuda.synchronize()
        e = err(got, want)
        m = timed_kernel(run, plain, library, moved, ops, rate, mem_rate)
        text = m.pop("text")
        del m["mb"]
        row = {"name": name, "route": "cuda", "source": route_src,
               "replaces": replaces, "launches": None, "max_abs_err": e["abs"], **m}
        print(f"phase {name}: {e['text']} (limit {tol}), {text} on {smi}")
        if not e["ok"]:
            raise AssertionError(f"{name} disagrees with its plain version: {e['text']}")
        kernels.append(row)
        return got

    digits = dec.decompose(cts[:, :-1], p.ks_base_log, p.ks_level)
    digits = digits.reshape(B, -1).to(torch.int8).contiguous()

    def exact(got, want):
        diff = (got - want).abs().max().item()
        return {"abs": float(diff), "ok": torch.equal(got, want),
                "text": f"mismatches {(got != want).sum().item()} of {got.numel()}"}

    def rel(tol):
        def check(got, want):
            d = (got - want).abs().max().item()
            scale = want.abs().max().item()
            return {"abs": d, "ok": d <= tol * scale,
                    "text": f"max_abs_err {d:.3e}, relative {d / scale:.3e}"}
        return check

    limbs = pack.ksk_limbs
    S, T = digits.shape[1], limbs.shape[0] // 8
    acc = torch.empty((B, T), dtype=torch.int64, device="cuda")
    phase("keyswitch_mac", "src/repro_torch/kernels/csrc/keyswitch.cu",
          "src/repro/kernels/keyswitch.py:91",
          lambda: ks.keyswitch_mac(digits, limbs),
          lambda: ks.keyswitch_mac_plain(digits, limbs), None,
          exact, "bit-exact", nbytes(digits, limbs, acc), 2 * B * S * 8 * T, peaks[2])

    J = (p.k + 1) * p.pbs_level
    K, M = p.k + 1, p.N // 2
    fft_src = "src/repro_torch/kernels/csrc/fft.cu"
    fwd_tpu = "src/repro/kernels/fourstep_fft.py:119"
    inv_tpu = "src/repro/kernels/fourstep_fft.py:139"
    x = torch.randint(-(1 << (p.pbs_base_log - 1)), 1 << (p.pbs_base_log - 1),
                      (B * J, p.N), generator=gen, device="cuda").to(torch.float64)
    u = torch.complex(x[:, :M], x[:, M:]) * ff.core_fft.twist(p.N, x.device)
    fft_flops = 5 * M * (M.bit_length() - 1) * x.shape[0]
    phase("fft_forward", fft_src, fwd_tpu,
          lambda: ff.fft_forward(x), lambda: ff.fft_forward_plain(x),
          lambda: torch.fft.fft(u, dim=-1), rel(1e-12), 1e-12,
          2 * nbytes(x), fft_flops, peaks[1])

    # A CMux step's prologue at the main path's shapes: an accumulator of
    # random torus values, shifts from the mod switch's range [0, 2N).
    acc_in = torus.random_torus(gen, (B, K, p.N), device="cuda")
    shifts = torch.randint(0, 2 * p.N, (B,), generator=gen, device="cuda")
    dig = phase("fft_forward_digits", fft_src, fwd_tpu,
                lambda: ff.fft_forward_digits(acc_in, shifts, p.pbs_base_log, p.pbs_level),
                lambda: ff.fft_forward_digits_plain(acc_in, shifts, p.pbs_base_log,
                                                    p.pbs_level),
                None, rel(1e-12), 1e-12,
                nbytes(acc_in, shifts) + B * 2 * J * M * 8, fft_flops, peaks[1])

    bsk_i = pack.bsk_planes[0]
    d_c, w_c = torch.complex(dig[:, 0], dig[:, 1]), torch.complex(bsk_i[0], bsk_i[1])
    out = phase("external_product_mac", "src/repro_torch/kernels/csrc/external_product.cu",
                "src/repro/kernels/external_product.py:44",
                lambda: ep.external_product_mac(dig, bsk_i),
                lambda: ep.external_product_mac_plain(dig, bsk_i),
                lambda: torch.einsum("bjf,jkf->bkf", d_c, w_c), rel(1e-9), 1e-9,
                nbytes(dig, bsk_i) + B * 2 * K * M * 8, 8 * B * J * K * M, peaks[1])

    planes = out.transpose(1, 2).reshape(B * K, 2, M).contiguous()
    z = torch.complex(planes[:, 0], planes[:, 1])
    inv_flops = 5 * M * (M.bit_length() - 1) * planes.shape[0]
    phase("fft_inverse", fft_src, inv_tpu,
          lambda: ff.fft_inverse(planes), lambda: ff.fft_inverse_plain(planes),
          lambda: torch.fft.ifft(z, dim=-1), rel(1e-12), 1e-12,
          2 * nbytes(planes), inv_flops, peaks[1])

    # The torus output may differ by the f64 transform's rounding (1e-12 of
    # the float inverse's scale) and one unit of the final rounding.
    x_scale = ff.fft_inverse_plain(planes).abs().max().item()

    def torus_close(got, want):
        d = (got - want).abs().max().item()
        lim = 1e-12 * x_scale + 1
        return {"abs": float(d), "ok": d <= lim,
                "text": f"max wrapped int64 diff {d:.3e} (float scale {x_scale:.3e})"}

    phase("fft_inverse_torus", fft_src, inv_tpu,
          lambda: ff.fft_inverse_torus(out, acc_in),
          lambda: ff.fft_inverse_torus_plain(out, acc_in), None,
          torus_close, "1e-12 x scale + 1",
          nbytes(out, acc_in) + nbytes(acc_in), inv_flops, peaks[1])

    # -- kernels.ops: the reference's f32 planes and int32 keyswitch digits ----
    opsed = ops_phase(ctx, gen, peaks, smi)
    print(json.dumps({"ops": {"checks": opsed["checks"], "launches": opsed["launches"]}}))

    # -- one CMux step against the exact product: the kernels' float error ---
    accuracy = {}
    for ap in (p, PAPER_PARAMS["xgboost"]):
        e = step_errors(ap, B, gen)
        ratio = e["kernels"]["rms"] / e["torch_fft"]["rms"]
        accuracy[ap.name] = {**e, "rows": B, "ratio": ratio}
        print(f"CMux step at {ap.name}'s shapes (PBS gadget 2^{ap.pbs_base_log} x "
              f"{ap.pbs_level}), {B} rows, coefficient error against the exact product: "
              f"kernels rms 2^{math.log2(e['kernels']['rms']):.3f} max 2^"
              f"{math.log2(e['kernels']['max']):.3f}, torch.fft rms 2^"
              f"{math.log2(e['torch_fft']['rms']):.3f} max 2^"
              f"{math.log2(e['torch_fft']['max']):.3f} of the torus; ratio {ratio:.3f} "
              f"(limit {STEP_ERROR_RATIO}) on {smi}")
        if ratio > STEP_ERROR_RATIO:
            raise AssertionError(f"CMux step at {ap.name}: the kernels' error is {ratio:.3f}x "
                                 "the torch.fft pipeline's")
    print(json.dumps({"cmux_accuracy": accuracy}))

    # -- the main path: two chained fused rounds, reference on round 1 --------
    rng = torch.Generator().manual_seed(SEED)
    t1 = torch.randperm(p.plaintext_modulus, generator=rng)
    t2 = (torch.arange(p.plaintext_modulus) * 5 + 7) % p.plaintext_modulus
    want1 = t1[msgs.cpu()]
    want2 = t2[want1]
    per_round = {"keyswitch_mac": 1, "fft_forward": p.n, "fft_inverse": p.n,
                 "external_product_mac": p.n}
    _build.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out1 = engine.lut_batch_tables(cts, t1)
    torch.cuda.synchronize()
    s1 = time.perf_counter() - t0
    c1 = _build.launch_counts()
    t0 = time.perf_counter()
    out2 = engine.lut_batch_tables(out1, t2)
    torch.cuda.synchronize()
    s2 = time.perf_counter() - t0
    c2 = _build.launch_counts()
    assert engine.fused_pack is pack, "the pack was rebuilt between rounds"
    round2 = {k: c2[k] - c1[k] for k in c2}
    print(f"launches round 1 {c1}, round 2 {round2}")
    if c1 != per_round or round2 != per_round:
        raise AssertionError(f"launch counts per round should be {per_round}")
    dec1, dec2 = ctx.decrypt(out1).cpu(), ctx.decrypt(out2).cpu()
    print(f"round 1 (fused): decrypt {dec1.tolist()} want {want1.tolist()}")
    print(f"round 2 (fused): decrypt {dec2.tolist()} want {want2.tolist()}")
    if not (torch.equal(dec1, want1) and torch.equal(dec2, want2)):
        raise AssertionError("fused rounds do not decrypt to the plaintext tables")
    ref_engine = TaurusEngine.from_context(ctx, kernel_backend="reference")
    t0 = time.perf_counter()
    out_ref = ref_engine.lut_batch_tables(cts, t1)
    torch.cuda.synchronize()
    s_ref = time.perf_counter() - t0
    dec_ref = ctx.decrypt(out_ref).cpu()
    print(f"round 1 (reference): decrypt {dec_ref.tolist()}")
    if not torch.equal(dec_ref, dec1):
        raise AssertionError("reference backend does not decrypt like the fused one")
    noise = ctx.decrypt_noise(out2, want2.to("cuda")).abs().max().item()
    print(f"main path {p.name} B={B}: fused round 1 {s1:.3f} s, round 2 {s2:.3f} s "
          f"({s2 / B * 1e3:.2f} ms per PBS), reference round 1 {s_ref:.3f} s, "
          f"round-2 max |noise| 2^{torch.tensor(noise).log2().item():.1f} of the torus "
          f"(half a slot is 2^{-(p.width + p.padding_bits + 1)}), "
          f"peak memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB on {smi}")

    profile_round(lambda: engine.lut_batch_tables(out2, t1), s2, smi, p.n)
    del out1, out_ref, ref_engine

    # -- the radix path: the quickstart program on 32-bit integers ----------
    radix = radix_phase(ctx, smi)
    largest = radix["largest"]

    # -- the encrypted GPT-2 block, both lowering families, on one engine ------
    fhe = fhe_ml_phase(ctx, engine, peaks, smi)
    print(json.dumps({"fhe_ml": {k: fhe[k] for k in ("runs", "kernels_radix_keys")}}))

    at_rows = kernels_at_rows(largest["cts"], pack, gen, peaks, smi)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    big = profile_round(lambda: largest["engine"].lut_batch(largest["cts"], largest["polys"]),
                        largest["wall_s"], smi, p.n, "profile_round288.json")
    peak = torch.cuda.max_memory_allocated()
    if _build.launch_counts() != per_round:
        raise AssertionError(f"{largest['rows']}-row round launches {_build.launch_counts()}")
    if not torch.equal(ctx.decrypt(big["result"]), ctx.decrypt(largest["out"])):
        raise AssertionError(f"the profiled {largest['rows']}-row round decrypts unlike "
                             "its run in the program")
    # one resident pack per key: every fused engine alive reads `pack`
    engines = [engine] + [s.engine for s in radix["sessions"]]
    if any(e.fused_pack is not pack for e in engines):
        raise AssertionError("an engine of this key holds a pack of its own")
    print(f"profile {largest['rows']}-row round: device busy {big['busy_ms']:.1f} ms, idle "
          f"share {big['idle_share']:.3f} of its untraced {largest['wall_s']:.3f} s, peak "
          f"device memory {peak / 1e9:.2f} GB with {len(engines)} fused engines alive on "
          f"one resident pack, on {smi}")
    print(json.dumps({"radix": radix["results"], "round288": {
        "rows": largest["rows"], "wall_s": largest["wall_s"], "busy_ms": big["busy_ms"],
        "idle_share": big["idle_share"], "events": big["events"], "peak_gb": peak / 1e9,
        "engines_alive": len(engines),
        "by_kernel": big["by_kernel"], "kernels": at_rows}}))

    # -- the serving runtime: four concurrent clients on the main engine -------
    served = serve_phase(ctx, engine, radix, fhe, peaks, smi)
    print(json.dumps({"serve": served}))

    # -- the no-key-reuse baseline and seeded traffic, on the main engine -----
    xpu = xpu_phase(ctx, engine, peaks, smi)
    print(json.dumps({"xpu": xpu}))
    simmed = sim_phase(ctx, engine, peaks, smi)
    print(json.dumps({"sim": simmed}))

    # -- the LM stack's serving path, at full width and every reduced config ---
    print(json.dumps({"lm": lm_phase(smi, peaks)}))

    # -- LM training at full width, with a failure and a restore ----------------
    print(json.dumps({"train": train_phase(smi, peaks)}))

    # -- a fused round past the grid's rows; the multi-device paths on one card ----
    grid = grid_rows_phase(smi)
    meshed = mesh_phase(ctx, smi)
    print(json.dumps({"grid_rows": grid, "mesh": meshed}))

    counter = {"fft_forward_digits": "fft_forward", "fft_inverse_torus": "fft_inverse"}
    for row in kernels:
        key = counter.get(row["name"], row["name"])
        row["launches"] = round2[key]
        row["launches_radix"] = {b: r["launches"][key] for b, r in radix["results"].items()}
        row["launches_fhe_ml"] = {f"{block} {b}": r["launches"][key]
                                  for block, runs in fhe["runs"].items()
                                  for b, r in runs.items()}
        m = at_rows.get(row["name"])
        if m is not None:
            row.update({f"{k}_288": m[k] for k in ("ms", "ms_b2b", "bound_ms", "bound_by",
                                                   "library_ms")})
        m = fhe["kernels_radix_keys"].get(row["name"])
        if m is not None:       # the radix GPT-2 block's largest round, PBS level 2
            row.update({f"{k}_radix96": m[k] for k in ("max_abs_err", "ms", "ms_b2b",
                                                       "bound_ms", "bound_by", "library_ms")})
        row["launches_serve"] = {"one_shard": served["one_shard"]["launches"][key],
                                 "two_shards": served["two_shards"]["launches"][key]}
        m = served["kernels"].get(row["name"])
        if m is not None:       # the serve wave's largest fused round
            row.update({f"{k}_serve": m[k] for k in ("rows", "max_abs_err", "ms", "ms_b2b",
                                                     "bound_ms", "bound_by", "library_ms")})
        row["launches_xpu"] = {name: r["launches"][key] for name, r in xpu["runs"].items()}
        row["launches_sim"] = simmed["launches"][key]
        row["launches_mesh"] = {name: at[key] for name, at in meshed["launches"].items()}
        row["launches_grid_rows"] = grid["launches"][key]
        for tag, at in (("xpu1", xpu["kernels_1row"]), ("sim", simmed["kernels"])):
            m = at.get(row["name"])
            if m is not None:   # the XPU pass's one-row rounds; the sim's largest
                row.update({f"{k}_{tag}": m[k] for k in ("rows", "max_abs_err", "ms",
                                                         "ms_b2b", "bound_ms", "bound_by",
                                                         "library_ms")})
    kernels += opsed["rows"]

    # -- the LM dry run on fake production meshes; the six demos ----------------
    dry = dryrun_phase(smi)
    demos = examples_phase(smi)
    print(json.dumps({"dryrun": dry, "examples": demos}))
    print(json.dumps({"kernels": kernels}))
    print(f"card: {smi}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": card, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
