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
6. each kernel again at the largest round's shapes (288 rows), against
   its plain version, timed one call at a time and back to back (the MAC
   beside `torch.einsum`), and that round under `torch.profiler`
   (`build/profile_round288.json`): device time by kernel, busy and idle
   share, peak device memory (keys, the resident pack with its KSK limb
   operand, the round's working set).

Prints the card, the build time, a line per phase, a `{"radix": ...}` and
a `{"kernels": ...}` JSON line and, last, `{"ok": true, "device": {...}}`.  Any failure
raises and exits nonzero.  Needs CUDA; imports nothing of JAX.
"""
from __future__ import annotations

import collections
import contextlib
import json
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

# Data-sheet peaks by card (NVIDIA H100 data sheet, dense): memory bytes/s,
# FP64 FLOP/s (tensor cores), int8 tensor-core OP/s.  Matched on the name
# nvidia-smi reports.
PEAKS = {"H100 PCIe": (2.0e12, 51.2e12, 1513e12), "H100 NVL": (3.9e12, 60e12, 1671e12),
         "H100": (3.35e12, 67e12, 1979e12)}


def card_peaks(name: str) -> tuple[float, float, float]:
    for key, peaks in PEAKS.items():
        if key in name:
            return peaks
    raise RuntimeError(f"no data-sheet peaks for {name!r}")


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


def profile_round(run, untraced_s: float, smi: str, steps: int,
                  trace: str = "profile_round.json") -> dict:
    """Trace one call of `run` and print where the device time goes.
    Raises if the round holds more than 3 device events per CMux step
    (forward, MAC, inverse) plus 200 for the rest of the round.  Returns
    the call's result and the device busy ms, idle share and ms by kernel."""
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
    busy = sum(v[1] for v in by_name.values())
    print(f"profile: {len(events)} device events per round, "
          f"{len(events) / steps:.2f} per CMux step ({steps} steps)")
    if len(events) > 3 * steps + 200:
        raise AssertionError(f"profile: {len(events)} device events in a round, more "
                             f"than 3 per CMux step + 200 = {3 * steps + 200}")
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
    program runs its rounds on shapes alone and logs each round's rows."""
    kernel_backend = "fused"

    def __init__(self, device):
        self.device = device
        self.rows = []

    def lut_batch(self, cts, polys):
        self.rows.append(int(cts.shape[0]))
        return cts

    def keyswitch(self, cts):
        return cts

    def lut_batch_small(self, small, polys):
        return self.lut_batch(small, polys)


def logical_pbs(backend, graph) -> int:
    """Logical PBS a backend ran: its integer context's plus the lut nodes'."""
    ic = getattr(backend, "int_ctx", None) or backend.interp.int_ctx
    return ic.stats["pbs"] + sum(n.n_elements for n in graph.nodes if n.op == "lut")


def radix_phase(ctx, smi: str) -> dict:
    """The quickstart program on 32-bit integers through the eager and the
    local backend; raises on a wrong decrypt, a round count off the plan
    or launch counts off rounds x (1, n, n, n).  Returns per-backend
    results and the largest round's inputs and output (from eager)."""
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
    results, largest = {}, {}
    for backend in ("eager", "local"):
        sess = Session(ctx, backend=backend, kernel_backend="fused")
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
    return {"results": results, "largest": largest}


def kernels_at_rows(cts, pack, gen, peaks: tuple, smi: str) -> dict:
    """Each kernel on the shapes a round of `cts.shape[0]` rows gives it,
    against its plain version, timed one call at a time and back to
    back, beside its bound and, for the MAC, `torch.einsum` on the same
    inputs.  Returns {row name: measurements}."""
    import torch
    from repro_torch.core import decompose as dec, torus
    from repro_torch.kernels import external_product as ep, fourstep_fft as ff
    from repro_torch.kernels import keyswitch as ks
    mem_rate, fp64_rate, int8_rate = peaks
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
        ms, ms_b2b = cuda_ms(run, 5), b2b_ms(run, 10)
        lib_ms = cuda_ms(library, 5) if library else None
        t_bytes, t_ops = moved / mem_rate * 1e3, ops / rate * 1e3
        by = "bytes" if t_bytes >= t_ops else "operations"
        out[name] = {"rows": R, "ms": ms, "ms_b2b": ms_b2b, "bound_ms": max(t_bytes, t_ops),
                     "bound_by": by, "bytes_ms": t_bytes, "ops_ms": t_ops,
                     "library_ms": lib_ms, "mb": moved / 1e6, "max_abs_err": d}
        print(f"phase {name} at {R} rows: max_abs_err {d:.3e} ({'ok' if ok else 'FAILED'}, "
              f"limit {tol}), kernel_ms {ms:.4f}, back-to-back {ms_b2b:.4f}, library_ms "
              f"{lib_ms}, bound_ms {max(t_bytes, t_ops):.4f} ({by}; bytes {t_bytes:.4f} for "
              f"{moved / 1e6:.2f} MB, operations {t_ops:.4f} for {ops:.3e}) on {smi}")
        if not ok:
            raise AssertionError(f"{name} at {R} rows disagrees with its plain version")
    return out


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
        row = {"name": name, "route": "cuda", "source": route_src,
               "replaces": replaces, "launches": None, "max_abs_err": e["abs"],
               "ms": cuda_ms(run), "ms_b2b": b2b_ms(run), "plain_ms": cuda_ms(plain, 5),
               "library_ms": cuda_ms(library) if library else None}
        t_bytes, t_ops = moved / mem_rate * 1e3, ops / rate * 1e3
        row["bound_ms"] = max(t_bytes, t_ops)
        row["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
        row["bytes_ms"], row["ops_ms"] = t_bytes, t_ops
        print(f"phase {name}: {e['text']} (limit {tol}), kernel_ms {row['ms']:.4f}, "
              f"back-to-back {row['ms_b2b']:.4f}, "
              f"plain_ms {row['plain_ms']:.4f}, library_ms {row['library_ms']}, "
              f"bound_ms {row['bound_ms']:.4f} ({row['bound_by']}; bytes {t_bytes:.4f} "
              f"for {moved / 1e6:.2f} MB, operations {t_ops:.4f} for {ops:.3e}) on {smi}")
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
    print(f"profile {largest['rows']}-row round: device busy {big['busy_ms']:.1f} ms, idle "
          f"share {big['idle_share']:.3f} of its untraced {largest['wall_s']:.3f} s, peak "
          f"device memory {peak / 1e9:.2f} GB on {smi}")
    print(json.dumps({"radix": radix["results"], "round288": {
        "rows": largest["rows"], "wall_s": largest["wall_s"], "busy_ms": big["busy_ms"],
        "idle_share": big["idle_share"], "events": big["events"], "peak_gb": peak / 1e9,
        "by_kernel": big["by_kernel"], "kernels": at_rows}}))

    counter = {"fft_forward_digits": "fft_forward", "fft_inverse_torus": "fft_inverse"}
    for row in kernels:
        key = counter.get(row["name"], row["name"])
        row["launches"] = round2[key]
        row["launches_radix"] = {b: r["launches"][key] for b, r in radix["results"].items()}
        m = at_rows.get(row["name"])
        if m is not None:
            row.update({f"{k}_288": m[k] for k in ("ms", "ms_b2b", "bound_ms", "bound_by",
                                                   "library_ms")})
    print(json.dumps({"kernels": kernels}))
    print(f"card: {smi}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": card, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
