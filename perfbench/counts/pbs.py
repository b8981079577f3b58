"""Frozen operation and byte counts of the PBS and its kernels, and the
card's data-sheet peaks: the benchmark's yardstick for rooflines and
for the round's share of the chip's peak.

Copied from the port's own arithmetic (`chip_smoke.py`'s kernel bounds,
`launch.roofline.pbs_kernel_bytes` / `pbs_round_model`,
`launch.pbs_dryrun.pbs_flops`) so that a later change to the program
cannot move them.  Each input byte is counted read once and each output
byte written once; an FFT of M complex points is 5 M log2 M flops.
`p` is a `perfbench.client.Params`.
"""
from __future__ import annotations

from typing import NamedTuple


class Peaks(NamedTuple):
    mem_bw: float        # device memory, bytes/s
    fp64_flops: float    # FP64 tensor-core FLOP/s
    int8_ops: float      # int8 tensor-core OP/s


# NVIDIA H100 data sheet, dense rates; the first key in the card's name wins
PEAKS = {"H100 PCIe": Peaks(2.0e12, 51.2e12, 1513e12),
         "H100 NVL": Peaks(3.9e12, 60e12, 1671e12),
         "H100": Peaks(3.35e12, 67e12, 1979e12)}


def card_peaks(name: str) -> Peaks:
    for key, peaks in PEAKS.items():
        if key in name:
            return peaks
    raise RuntimeError(f"no data-sheet peaks for {name!r}")


def fft_flops(M: int) -> float:
    return 5.0 * M * (M.bit_length() - 1)


def shapes(p) -> tuple:
    """(K, J, M): GLWE polynomials, gadget rows, complex points."""
    K = p.k + 1
    return K, K * p.pbs_level, p.N // 2


def fft_forward_digits(p, rows: int) -> tuple:
    """(bytes, flops) of one forward-digits launch over `rows`
    ciphertexts: reads the accumulator and the shifts, writes the digit
    planes; J transforms a row."""
    K, J, M = shapes(p)
    acc, dig = rows * K * p.N * 8, rows * 2 * J * M * 8
    return acc + rows * 8 + dig, rows * J * fft_flops(M)


def fft_inverse_torus(p, rows: int) -> tuple:
    """Reads the product planes and the accumulator, writes the
    accumulator; K transforms a row."""
    K, _, M = shapes(p)
    out, acc = rows * 2 * K * M * 8, rows * K * p.N * 8
    return out + 2 * acc, rows * K * fft_flops(M)


def external_product_mac(p, rows: int) -> tuple:
    """Reads the digit planes and one BSK slice, writes the product
    planes; a complex multiply-add (8 flops) per digit row, output
    polynomial and point."""
    K, J, M = shapes(p)
    return rows * 2 * J * M * 8 + 2 * J * K * M * 8 + rows * 2 * K * M * 8, 8.0 * rows * J * K * M


def key_bytes(p) -> int:
    """The evaluation keys a round reads: the Fourier BSK (complex128)
    and the KSK (int64)."""
    K, J, M = shapes(p)
    return p.n * J * K * M * 16 + p.big_n * p.ks_level * (p.n + 1) * 8


def round_flops(p, rows: int) -> float:
    """FP64 work of `rows` bootstraps: n CMux steps of J forward and K
    inverse transforms and the MAC."""
    K, J, M = shapes(p)
    return float(rows * p.n * ((J + K) * fft_flops(M) + 8 * J * K * M))


def keyswitch_ops(p, rows: int) -> float:
    """int8 tensor-core ops of the keyswitch: a digit times eight byte
    limbs of the 64-bit key, multiply and add, per digit and output."""
    return 2.0 * rows * p.big_n * p.ks_level * 8 * (p.n + 1)


def round_bytes_major(p, rows: int) -> int:
    """Keys once plus each ciphertext's input, output and test
    polynomial: no intermediate."""
    return key_bytes(p) + rows * (2 * (p.big_n + 1) + p.N) * 8


def round_min_s(p, rows: int, peaks: Peaks) -> float:
    """The least time a card needs for one fused round of `rows`
    bootstraps: the larger of its compute (FP64 transforms and MAC, then
    the keyswitch's int8 work) and its key and ciphertext traffic."""
    compute = round_flops(p, rows) / peaks.fp64_flops + keyswitch_ops(p, rows) / peaks.int8_ops
    return max(compute, round_bytes_major(p, rows) / peaks.mem_bw)


def launch_min_s(bytes_flops: tuple, peaks: Peaks) -> float:
    b, f = bytes_flops
    return max(b / peaks.mem_bw, f / peaks.fp64_flops)
