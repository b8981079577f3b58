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
   and the card's bound;
3. the main path: two chained `lut_batch_tables` rounds on the fused
   backend through one resident pack, each decrypting to its plaintext
   table, the reference backend decrypt-identical on round 1, and the
   per-round kernel launch counts (keyswitch 1, each FFT and the MAC n);
4. one more fused round under `torch.profiler`, which must hold at most
   3 device events per CMux step plus 200: its Chrome trace goes to
   `build/profile_round.json`, and the device time by kernel is printed
   with the device's idle share, that busy time against the wall time of
   the untraced round 2 (tracing slows the host, not the device).

Prints the card, the build time, a line per phase, a `{"kernels": ...}`
JSON line and, last, `{"ok": true, "device": {...}}`.  Any failure
raises and exits nonzero.  Needs CUDA; imports nothing of JAX.
"""
from __future__ import annotations

import collections
import json
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
SLEEP_CYCLES = 20_000_000   # about 10 ms of device time at the H100's clocks

# Data-sheet peaks by card (NVIDIA H100 data sheet): memory bytes/s, FP64
# FLOP/s (tensor cores).  Matched on the name nvidia-smi reports.
PEAKS = {"H100 PCIe": (2.0e12, 51.2e12), "H100 NVL": (3.9e12, 60e12),
         "H100": (3.35e12, 67e12)}


def card_peaks(name: str) -> tuple[float, float]:
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


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def profile_round(run, untraced_s: float, smi: str, steps: int) -> None:
    """Trace one call of `run` and print where the device time goes.
    Raises if the round holds more than 3 device events per CMux step
    (forward, MAC, inverse) plus 200 for the rest of the round."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    path = ROOT / "build" / "profile_round.json"
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
    mem_rate, fp64_rate = card_peaks(card)
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
    pack = engine.fused_pack
    msgs = (torch.arange(B, device="cuda") * 11 + 3) % p.plaintext_modulus
    cts = ctx.encrypt(gen, msgs)
    assert torch.equal(ctx.decrypt(cts), msgs), "fresh encryptions do not decrypt"

    # -- each kernel against its plain version at the main path's shapes ------
    kernels = []

    def phase(name, route_src, replaces, run, plain, library, err, tol,
              moved, flops):
        got, want = run(), plain()
        torch.cuda.synchronize()
        e = err(got, want)
        row = {"name": name, "route": "cuda", "source": route_src,
               "replaces": replaces, "launches": None, "max_abs_err": e["abs"],
               "ms": cuda_ms(run), "plain_ms": cuda_ms(plain, 5),
               "library_ms": cuda_ms(library) if library else None}
        t_bytes, t_ops = moved / mem_rate * 1e3, flops / fp64_rate * 1e3
        row["bound_ms"] = max(t_bytes, t_ops)
        row["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
        print(f"phase {name}: {e['text']} (limit {tol}), kernel_ms {row['ms']:.4f}, "
              f"plain_ms {row['plain_ms']:.4f}, library_ms {row['library_ms']}, "
              f"bound_ms {row['bound_ms']:.4f} ({row['bound_by']}, "
              f"{moved / 1e6:.2f} MB) on {smi}")
        if not e["ok"]:
            raise AssertionError(f"{name} disagrees with its plain version: {e['text']}")
        kernels.append(row)
        return got

    digits = dec.decompose(cts[:, :-1], p.ks_base_log, p.ks_level)
    digits = digits.reshape(B, -1).to(torch.int32).contiguous()

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

    acc = torch.empty((B, pack.ksk.shape[1]), dtype=torch.int64, device="cuda")
    phase("keyswitch_mac", "src/repro_torch/kernels/csrc/keyswitch.cu",
          "src/repro/kernels/keyswitch.py:91",
          lambda: ks.keyswitch_mac(digits, pack.ksk),
          lambda: ks.keyswitch_mac_plain(digits, pack.ksk), None,
          exact, "bit-exact", nbytes(digits, pack.ksk, acc), 0)

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
          2 * nbytes(x), fft_flops)

    # A CMux step's prologue at the main path's shapes: an accumulator of
    # random torus values, shifts from the mod switch's range [0, 2N).
    acc_in = torus.random_torus(gen, (B, K, p.N), device="cuda")
    shifts = torch.randint(0, 2 * p.N, (B,), generator=gen, device="cuda")
    dig = phase("fft_forward_digits", fft_src, fwd_tpu,
                lambda: ff.fft_forward_digits(acc_in, shifts, p.pbs_base_log, p.pbs_level),
                lambda: ff.fft_forward_digits_plain(acc_in, shifts, p.pbs_base_log,
                                                    p.pbs_level),
                None, rel(1e-12), 1e-12,
                nbytes(acc_in, shifts) + B * 2 * J * M * 8, fft_flops)

    bsk_i = pack.bsk_planes[0]
    d_c, w_c = torch.complex(dig[:, 0], dig[:, 1]), torch.complex(bsk_i[0], bsk_i[1])
    out = phase("external_product_mac", "src/repro_torch/kernels/csrc/external_product.cu",
                "src/repro/kernels/external_product.py:44",
                lambda: ep.external_product_mac(dig, bsk_i),
                lambda: ep.external_product_mac_plain(dig, bsk_i),
                lambda: torch.einsum("bjf,jkf->bkf", d_c, w_c), rel(1e-9), 1e-9,
                nbytes(dig, bsk_i) + B * 2 * K * M * 8, 8 * B * J * K * M)

    planes = out.transpose(1, 2).reshape(B * K, 2, M).contiguous()
    z = torch.complex(planes[:, 0], planes[:, 1])
    inv_flops = 5 * M * (M.bit_length() - 1) * planes.shape[0]
    phase("fft_inverse", fft_src, inv_tpu,
          lambda: ff.fft_inverse(planes), lambda: ff.fft_inverse_plain(planes),
          lambda: torch.fft.ifft(z, dim=-1), rel(1e-12), 1e-12,
          2 * nbytes(planes), inv_flops)

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
          nbytes(out, acc_in) + nbytes(acc_in), inv_flops)

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

    counter = {"fft_forward_digits": "fft_forward", "fft_inverse_torus": "fft_inverse"}
    for row in kernels:
        row["launches"] = round2[counter.get(row["name"], row["name"])]
    print(json.dumps({"kernels": kernels}))
    print(f"card: {smi}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": card, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
