"""Noise probe: the true phase error of every PBS input of a radix program.

    python3 src/repro_torch/noise_probe.py

Runs the radix GPT-2 block `lower_gpt2_block_radix(2, bits=16,
msg_bits=2, seed=1)` on the card through `Session(backend="eager")`, 6
times per parameter set, each on a fresh encryption of the block's test
input.  Before each run a shadow run of the same program replaces every
PBS round by its exact table lookup on noiseless trivial ciphertexts,
which gives the plaintext each PBS input row should hold; the real run
then measures each input row's phase error against it, in half slots
(1.0 is the point where the blind rotation picks a neighbouring slot).

Parameter sets: `PAPER_PARAMS["gpt2"]` (PBS gadget 2^22 x 1), on the
fused kernels and on the plain PyTorch pipeline (`kernel_backend=
"reference"`) over the same keys and the same encryptions, row for row;
`gpt2_pbs15x2()` (PBS gadget 2^15 x 2) on the fused kernels.
Per set it also measures a fresh PBS's output noise (an identity table on
the same fresh encryptions) on both kernel backends, beside
`core.noise`'s model.
Prints a line per run and per set, then one JSON summary.
"""
from __future__ import annotations

import dataclasses
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

if __name__ == "__main__":              # run as a script: put `src` on the path
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from repro_torch.core import lwe, noise, torus  # noqa: E402
from repro_torch.core.params import PAPER_PARAMS, TFHEParams  # noqa: E402

SEED = 2509
REPEATS = 6
FRESH_ROWS, FRESH_BATCHES = 288, 2


def gpt2_pbs15x2() -> TFHEParams:
    """gpt2's n, N, k, width and keyswitch with the 2^15 x 2 PBS gadget
    that `core.params._paper` gives widths 7-8: the decomposition keeps
    30 bits where gpt2's keeps 22, so the blind rotation's rounding noise
    falls by 2^8 in std.  The probe's comparison set for gpt2's margin."""
    return dataclasses.replace(PAPER_PARAMS["gpt2"], name="gpt2-pbs15x2",
                               pbs_base_log=15, pbs_level=2)


def probe_run(sess, prog, enc) -> dict:
    """Run `prog` on `sess`'s eager backend twice: a shadow run whose PBS
    rounds are exact table lookups on trivial ciphertexts, then the real
    run, measuring every PBS input row's phase error (in half slots)
    against the plaintext the shadow run gave it.  Returns the outputs,
    the errors of every row and the rows past half a slot per round."""
    ctx, p = sess.ctx, sess.params
    ic = sess.backend.int_ctx
    slots = 1 << (p.width + p.padding_bits)
    half = 2.0 ** -(p.width + p.padding_bits + 1)
    real = ic._lut
    expected = []

    def shadow(cts, tables):
        ph = lwe.decrypt_phase(ctx.big_sk, cts)
        m = torus.decode(ph, p.delta, slots)
        expected.append(m)
        t = torch.as_tensor(np.asarray(tables, np.int64), device=cts.device)
        out = t[torch.arange(t.shape[0], device=cts.device), m % t.shape[1]]
        return lwe.trivial(torus.encode(out, p.delta, device=cts.device), p.big_n)

    ic._lut = shadow
    try:
        sess.backend.run(prog.graph, enc)
    finally:
        ic._lut = real
    plan = iter(expected)
    errors, past = [], []

    def measured(cts, tables):
        ph = lwe.decrypt_phase(ctx.big_sk, cts)
        want = torus.encode(next(plan), p.delta, device=cts.device)
        err = ((ph - want).to(torch.float64) / 2.0 ** 64 / half).abs()
        errors.append(err.cpu())
        past.append(int((err > 1).sum()))
        return real(cts, tables)

    ic._lut = measured
    try:
        outs = sess.run(prog, enc)
    finally:
        ic._lut = real
    return {"outs": outs, "errors": torch.cat(errors).numpy(), "past_half": past}


def fresh_pbs_noise(ctx, engines: dict, gen) -> dict:
    """A fresh PBS's output noise on each of two engines: the identity
    table on the same fresh encryptions of random messages, FRESH_BATCHES
    rounds of FRESH_ROWS rows.  Returns per engine the mean and std of
    the signed output noise (torus units), and the largest difference
    between the engines' noise on one row."""
    p = ctx.params
    ident = torch.arange(p.plaintext_modulus, device=ctx.device)
    noises = {name: [] for name in engines}
    for _ in range(FRESH_BATCHES):
        m = torch.randint(0, p.plaintext_modulus, (FRESH_ROWS,), generator=gen,
                          device=ctx.device)
        cts = ctx.encrypt(gen, m)
        for name, eng in engines.items():
            noises[name].append(ctx.decrypt_noise(eng.lut_batch_tables(cts, ident), m))
    out = {}
    for name, parts in noises.items():
        e = torch.cat(parts)
        std = float(e.std())
        out[name] = {"rows": int(e.numel()), "mean": float(e.mean()), "std": std,
                     "log2_std": math.log2(std), "max_abs": float(e.abs().max())}
        noises[name] = e
    a, b = noises.values()
    out["max_abs_diff"] = float((a - b).abs().max())
    out["model_log2_std"] = 0.5 * math.log2(noise.pbs_out_var(p))
    return out


def error_summary(errors: list, past: list, wrong: int) -> dict:
    e = np.concatenate(errors)
    return {"wrong_decrypts": wrong, "rows": int(e.size), "rows_past_half_slot": past,
            **{f"q{x}": float(np.quantile(e, x)) for x in (0.5, 0.9, 0.99, 0.999)},
            "max": float(e.max())}


def probe_set(p, backends: tuple, block, smi: str) -> dict:
    """Keys of `p` from SEED, a fresh PBS's noise on both kernel
    backends, then REPEATS runs of the block, each on one fresh
    encryption run on every kernel backend in `backends`."""
    from repro_torch.api import Session
    from repro_torch.core.pbs import TFHEContext
    g, meta, q, want = block
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    ctx = TFHEContext.create(gen, p, device="cuda")
    sessions = {kb: Session(ctx, backend="eager", kernel_backend=kb)
                for kb in ("fused", "reference")}
    fresh = fresh_pbs_noise(ctx, {kb: s.engine for kb, s in sessions.items()},
                            torch.Generator(device="cuda").manual_seed(SEED + 1))
    for kb in sessions:
        f = fresh[kb]
        print(f"{p.name} fresh PBS on {kb}: output noise mean {f['mean']:.3e}, std "
              f"2^{f['log2_std']:.3f} (model 2^{fresh['model_log2_std']:.3f}), max |noise| "
              f"{f['max_abs']:.3e} over {f['rows']} rows on {smi}", flush=True)
    sessions = {kb: sessions[kb] for kb in backends}
    progs = {kb: s.compile(g, meta["in_specs"], meta["out_specs"]) for kb, s in sessions.items()}
    runs = {kb: {"errors": [], "past": [], "wrong": 0} for kb in backends}
    diffs = []
    for rep in range(REPEATS):
        enc = sessions[backends[0]].encrypt_inputs(gen, [q], progs[backends[0]])
        errs = {}
        for kb, sess in sessions.items():
            t0 = time.perf_counter()
            run = probe_run(sess, progs[kb], enc)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            got = [int(v) for v in sess.decrypt_outputs(progs[kb], run["outs"])[0]]
            past = run["past_half"]
            r = runs[kb]
            r["wrong"] += got != want
            r["errors"].append(run["errors"])
            r["past"].append(sum(past))
            errs[kb] = run["errors"]
            print(f"{p.name} {kb} run {rep}: decrypt {got} oracle {want} "
                  f"{'ok' if got == want else 'WRONG'}; {len(past)} rounds, {sum(past)} input "
                  f"rows past half a slot (rounds {[i for i, c in enumerate(past) if c]}); "
                  f"shadow + run {wall:.2f} s on {smi}", flush=True)
        if len(errs) > 1:
            a, b = errs.values()
            diffs.append({"max_abs_diff": float(np.abs(a - b).max()),
                          "past_half_disagree": int(((a > 1) != (b > 1)).sum())})
    out = {"params": dataclasses.asdict(p), "runs": REPEATS, "fresh_pbs": fresh,
           "block": {kb: error_summary(r["errors"], r["past"], r["wrong"])
                     for kb, r in runs.items()}}
    if diffs:
        out["fused_vs_reference"] = diffs
    for kb, s in out["block"].items():
        print(f"{p.name} {kb}: {s['wrong_decrypts']} of {REPEATS} decrypts wrong; {s['rows']} "
              f"PBS input rows, {sum(s['rows_past_half_slot'])} past half a slot; error in half "
              f"slots: median {s['q0.5']:.4f}, 90% {s['q0.9']:.4f}, 99% {s['q0.99']:.4f}, "
              f"99.9% {s['q0.999']:.4f}, max {s['max']:.4f} on {smi}")
    for rep, d in enumerate(diffs):
        print(f"{p.name} run {rep}, fused against reference row for row: max |error "
              f"difference| {d['max_abs_diff']:.3e} half slot, {d['past_half_disagree']} rows "
              f"past half a slot on one side only")
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("noise_probe: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.fhe_ml import lower
    from repro_torch.fhe_ml.quantize import calibrate_radix, quantize_to_radix
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    print(f"card: {smi}")
    g, meta = lower.lower_gpt2_block_radix(2, bits=16, msg_bits=2, seed=1)
    xf = np.random.default_rng(3).uniform(-1, 1, size=(2,))
    q = quantize_to_radix(xf, calibrate_radix(xf, 16, 2, qmax=meta["input_qmax"]))
    block = (g, meta, q, [int(v) for v in meta["int_fn"](q) % (1 << 16)])
    summary = {}
    for p, backends in ((PAPER_PARAMS["gpt2"], ("fused", "reference")),
                        (gpt2_pbs15x2(), ("fused",))):
        summary[p.name] = probe_set(p, backends, block, smi)
        torch.cuda.empty_cache()
    print(json.dumps({"noise_probe": summary}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
