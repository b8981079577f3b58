#!/usr/bin/env python3
"""Float error of one CMux step's external product against the exact one.

    python3 src/repro_torch/kernels/cmux_accuracy.py

A blind rotation adds `bsk_i ⊡ (X^a acc - acc)` to acc n times, each
through a float64 FFT product that rounds; the error lands in every
coefficient of the accumulator, and the phase carries it times the
GLWE key, so it adds to the PBS output noise like the gadget's own
rounding.  This measures it for one step at a parameter set's shapes:
random acc, shifts and time-domain GGSW polynomials (uniform 64-bit,
turned into the Fourier BSK by `core.fft.forward`, as
`ggsw.bsk_to_fourier` does), the step's result exact mod 2^64
(`exact_mac`), then through the port's three kernels (`fft_forward_digits`,
`external_product_mac`, `fft_inverse_torus`) and through the plain
`torch.fft` pipeline of the engine's "reference" backend, and prints the
rms and max of each one's coefficient error in torus units.  Needs CUDA;
on CPU tensors `step_errors` runs the kernels' plain versions.
"""
from __future__ import annotations

import math
import subprocess
import sys
from pathlib import Path

import torch

if __name__ == "__main__":              # run as a script: put `src` on the path
    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from repro_torch.core import batch as batch_mod, decompose as dec, fft, torus  # noqa: E402
from repro_torch.core.params import TFHEParams  # noqa: E402

SEED = 2509
LIMB_BITS = 8


def exact_mac(digits: torch.Tensor, polys: torch.Tensor) -> torch.Tensor:
    """out[b, k] = sum_j digits[b, j] * polys[j, k] mod (X^N + 1, 2^64),
    exactly: digits (B, J, N) int64 small, polys (J, K, N) int64 torus.
    Each poly is split into 8-bit limbs, whose products with the digits
    stay under 2^53 and come out of a float64 FFT product exact after
    rounding (checked), then shifted back and summed wrapping."""
    B, J, N = digits.shape
    bound = J * N * int(digits.abs().max()) * (1 << LIMB_BITS)
    if bound >= 1 << 50:
        raise ValueError(f"limb products reach 2^{math.log2(bound):.1f}, past exact f64")
    d_f = fft.forward(digits)                                   # (B, J, M)
    out = torch.zeros((B, polys.shape[1], N), dtype=torch.int64, device=digits.device)
    mask = (1 << LIMB_BITS) - 1
    for l in range(64 // LIMB_BITS):
        limb = (polys >> (LIMB_BITS * l)) & mask                # arithmetic shift, masked
        x = fft.inverse(torch.einsum("bjf,jkf->bkf", d_f, fft.forward(limb)))
        c = torch.round(x)
        if float((x - c).abs().max()) > 0.25:
            raise AssertionError("a limb product did not come out exact")
        out += c.to(torch.int64) * (1 << (LIMB_BITS * l))       # wraps mod 2^64
    return out


def step_errors(p: TFHEParams, rows: int, gen: torch.Generator) -> dict:
    """One CMux step at `p`'s shapes on `rows` random accumulators:
    {"kernels": ..., "torch_fft": ...}, each the rms and max of the
    coefficient error (torus units) against `exact_mac`."""
    from repro_torch.kernels import external_product as ep, fourstep_fft as ff
    dev = gen.device
    K, N, level, base_log = p.k + 1, p.N, p.pbs_level, p.pbs_base_log
    J = K * level
    acc = torus.random_torus(gen, (rows, K, N), device=dev)
    shifts = torch.randint(0, 2 * N, (rows,), generator=gen, device=dev)
    polys = torus.random_torus(gen, (J, K, N), device=dev)
    bsk_f = fft.forward(polys)                                  # (J, K, M)
    planes = torch.stack([bsk_f.real, bsk_f.imag]).contiguous()  # (2, J, K, M)
    diff = batch_mod.rotate_batch(acc, shifts, N) - acc
    digits = dec.decompose(diff, base_log, level).movedim(-1, -2).reshape(rows, J, N)
    want = acc + exact_mac(digits, polys)
    dig = ff.fft_forward_digits(acc, shifts, base_log, level)
    got = {"kernels": ff.fft_inverse_torus(ep.external_product_mac(dig, planes), acc),
           "torch_fft": acc + fft.inverse_torus(
               torch.einsum("bjf,jkf->bkf", fft.forward(digits), bsk_f))}
    out = {}
    for name, g in got.items():
        e = (g - want).to(torch.float64) / 2.0 ** 64
        out[name] = {"rms": float(e.pow(2).mean().sqrt()), "max": float(e.abs().max())}
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("cmux_accuracy: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.core.params import PAPER_PARAMS
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    for p in (PAPER_PARAMS["gpt2"], PAPER_PARAMS["xgboost"]):
        e = step_errors(p, 12, gen)
        print(f"{p.name} (PBS gadget 2^{p.pbs_base_log} x {p.pbs_level}), one CMux step "
              f"at 12 rows: coefficient error rms / max, kernels 2^"
              f"{math.log2(e['kernels']['rms']):.3f} / 2^{math.log2(e['kernels']['max']):.3f}, "
              f"torch.fft 2^{math.log2(e['torch_fft']['rms']):.3f} / 2^"
              f"{math.log2(e['torch_fft']['max']):.3f} of the torus on {smi}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
