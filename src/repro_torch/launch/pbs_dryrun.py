"""Roofline the FHE engine on one card: the port of
`repro.launch.pbs_dryrun`.

The batched PBS (the paper's key reuse: the BSK streams once per round,
whatever the batch) against the XPU-style per-ciphertext loop
(`TaurusEngine.lut_batch_xpu`: the BSK streams once per ciphertext), as
roofline terms from analytic counts on one card — the paper's Fig. 7
comparison:

    python -m repro_torch.launch.pbs_dryrun [--params gpt2] [--batch 12]

FLOPs come from `pbs_flops`.  Bytes are `pbs_round_model`'s
`fused_bytes` / `unfused_bytes` (keys, ciphertext rows and LUTs) plus
what the kernels move besides the keys (`roofline.pbs_kernel_bytes`:
digits, transform planes, products and the accumulator, which the
paper's accelerator keeps on chip and the card does not).  The
`*_major` terms count the model's bytes alone.

The reference lowers both variants onto a 512-device host mesh and reads
the terms from compiled HLO.  The port's engine runs on one card, which
is one cluster, so there is no mesh and no collective term.  The
counts follow from the parameters alone; the command line takes the
peaks of the visible card.
"""
from __future__ import annotations

import argparse
import json

from repro_torch.core.params import PAPER_PARAMS, TEST_PARAMS_4BIT
from repro_torch.launch import roofline as rl


def pbs_flops(params, B):
    """Useful FLOPs of B bootstraps: n iterations x (FFT + MAC + IFFT)."""
    p = params
    M = p.N // 2
    j = (p.k + 1) * p.pbs_level
    fft = (j + (p.k + 1)) * 5 * M * (M.bit_length() - 1)   # 5 N log N
    mac = 8 * j * (p.k + 1) * M                            # complex MAC
    return float(B * p.n * (fft + mac))


def operand_bytes(params, B: int) -> int:
    """Bytes the kernels of B bootstraps move besides the evaluation keys:
    the keyswitch's digits and sums, and per CMux step the forward FFT's,
    the MAC's and the inverse FFT's non-key operands."""
    one = rl.pbs_kernel_bytes(params, 1)
    zero = rl.pbs_kernel_bytes(params, 0)          # the key operands alone
    per_row = {k: one[k] - zero[k] for k in one}
    steps = (per_row["fft_forward_digits"] + per_row["external_product_mac"]
             + per_row["fft_inverse_torus"])
    return B * (per_row["keyswitch_mac"] + params.n * steps)


def run(params_name: str, B: int = 192, peaks: rl.Peaks = rl.H100_SXM):
    params = (PAPER_PARAMS[params_name] if params_name in PAPER_PARAMS
              else TEST_PARAMS_4BIT)
    model = rl.pbs_round_model(params, B, peaks)
    flops = pbs_flops(params, B)
    work = operand_bytes(params, B)
    rows = []
    for batched in (True, False):
        keyed = model.fused_bytes if batched else model.unfused_bytes
        roof = rl.from_counts(flops, keyed + work, 1, model_flops=flops,
                              hbm_bytes_major=keyed, peaks=peaks)
        rows.append({
            "variant": "taurus-batched" if batched else "xpu-per-ct",
            "params": params.name, "B": B, **roof.to_dict(),
            "per_pbs_bound_ms": roof.t_bound / B * 1e3,
            "per_pbs_bound_major_ms": roof.t_bound_major / B * 1e3,
        })
        print(f"[{rows[-1]['variant']:14s}] Tc={roof.t_compute:.3e}s "
              f"Tm={roof.t_memory:.3e}s Tm_major={roof.t_memory_major:.3e}s "
              f"-> {roof.bottleneck}, {rows[-1]['per_pbs_bound_ms']:.4f} ms "
              f"per PBS", flush=True)
    if rows[0]["t_memory_s"] > 0:
        gain = rows[1]["t_memory_s"] / rows[0]["t_memory_s"]
        major = rows[1]["t_memory_major_s"] / rows[0]["t_memory_major_s"]
        print(f"BSK-reuse memory-term gain (batched vs per-ct): {gain:.2f}x "
              f"({major:.2f}x on the keys and rows alone)")
    return rows


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--params", default="cnn20")
    ap.add_argument("--batch", type=int, default=192)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("pbs_dryrun: needs the card whose peaks it uses; "
                         "no CUDA device is visible")
    card = torch.cuda.get_device_name(0)
    print(f"peaks of {card}: {rl.card_peaks(card)}")
    rows = run(args.params, args.batch, rl.card_peaks(card))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1)


if __name__ == "__main__":
    main()
