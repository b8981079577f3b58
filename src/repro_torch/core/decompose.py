"""Signed gadget decomposition (the paper's Decomposer Unit, §IV-E).

Decomposes a torus element v (int64 bits of a uint64) into `level` signed
digits in [-B/2, B/2), B = 2^base_log, such that

    v  ~=  sum_l  digit_l * g_l,      g_l = 2^(64 - (l+1)*base_log)

with the closest-representative rounding.  Digit index l=0 is the MOST
significant level.

The reference shifts uint64 logically.  Here the rounding shift is a
logical shift (`torus.srl`), and the digit loop uses torch's arithmetic
`>>`: that gives the same digits because every digit is masked to
`base_log` bits and only `level * base_log` bits are ever read, so the
sign bits an arithmetic shift brings in (possible only when
`shift == 0`, where v is not pre-shifted) are never read.
"""
from __future__ import annotations

import torch

from repro_torch.core import torus

I64 = torch.int64


def decompose(v: torch.Tensor, base_log: int, level: int) -> torch.Tensor:
    """int64 (...,) -> int64 (..., level) signed digits, MSB level first."""
    assert v.dtype == I64
    B = 1 << base_log
    shift = 64 - base_log * level
    # round-to-nearest keep of the top `base_log * level` bits
    u = torus.srl(v + (1 << (shift - 1)), shift) if shift > 0 else v
    digits = []
    carry = torch.zeros_like(u)
    for _ in range(level):
        raw = (u & (B - 1)) + carry
        u = u >> base_log
        hi = raw >= B // 2
        digits.append(torch.where(hi, raw - B, raw))
        carry = hi.to(I64)
    # the final carry folds into bits beyond the kept window; dropped
    digits.reverse()
    return torch.stack(digits, dim=-1)


def recompose(digits: torch.Tensor, base_log: int, level: int) -> torch.Tensor:
    """Inverse of `decompose` up to the rounding error (for tests)."""
    out = torch.zeros(digits.shape[:-1], dtype=I64, device=digits.device)
    for l in range(level):
        out = out + digits[..., l] * torus.as_i64(1 << (64 - (l + 1) * base_log))
    return out
