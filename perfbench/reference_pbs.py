"""A plain batched programmable bootstrap, the benchmark's own.

Key switch first (big key -> small key), mod switch, blind rotation over
the bootstrapping key, sample extract: the textbook TFHE pipeline in
plain PyTorch, written from the client's coefficient-domain keys and
importing nothing of the program.  The transforms run in a chosen
precision: float64 is the precision the 64-bit torus needs, float32 is
the control that has to come out not correct.  The key switch is
integer arithmetic and exact in any precision: it runs as float64
matrix products over limbs of the key, whose sums stay below 2^53.

`ReferencePbs.lut_batch(cts, lut_polys)` (and its halves `keyswitch`,
`lut_batch_small`) has the engine's contract, so a run can put it in the
program's place: `install(engine, keys, dtype)`.
"""
from __future__ import annotations

import torch

from perfbench.client import ClientKeys, fold_fft, unfold_ifft

I64 = torch.int64


def decompose(v: torch.Tensor, base_log: int, level: int) -> torch.Tensor:
    """Signed gadget digits in [-B/2, B/2), most significant first:
    int64 (...,) -> (..., level)."""
    B = 1 << base_log
    shift = 64 - base_log * level
    if shift > 0:
        u = ((v + (1 << (shift - 1))) >> shift) & ((1 << (64 - shift)) - 1)
    else:
        u = v
    digits, carry = [], torch.zeros_like(u)
    for _ in range(level):
        raw = (u & (B - 1)) + carry
        u = u >> base_log
        hi = raw >= B // 2
        digits.append(torch.where(hi, raw - B, raw))
        carry = hi.to(I64)
    digits.reverse()
    return torch.stack(digits, dim=-1)


def rotate(polys: torch.Tensor, r: torch.Tensor, N: int) -> torch.Tensor:
    """X^r[b] * polys[b] for polys (B, C, N) and shifts r (B,) in [0, 2N)."""
    j = torch.arange(N, dtype=I64, device=polys.device)
    src = (j[None, :] - r[:, None]) % (2 * N)
    neg = src >= N
    idx = torch.where(neg, src - N, src)
    vals = torch.gather(polys, -1, idx[:, None, :].expand_as(polys))
    return torch.where(neg[:, None, :], -vals, vals)


def float_to_torus(x: torch.Tensor) -> torch.Tensor:
    """Round float64 values to int64 mod 2^64 (hi/lo split, exact)."""
    x = x.to(torch.float64)
    hi = torch.round(x / 2.0 ** 32)
    lo = x - hi * 2.0 ** 32
    return hi.to(I64) * (1 << 32) + torch.round(lo).to(I64)


class ReferencePbs:
    """Batched PBS with the transforms in `dtype` (float64 or float32)."""

    def __init__(self, keys: ClientKeys, dtype=torch.float64):
        p = self.params = keys.params
        self.dtype = dtype
        self.bsk_f = torch.stack([fold_fft(b.to(dtype)) for b in keys.bsk])
        # key-switching key as float64 limbs small enough for exact sums
        S = p.big_n * p.ks_level
        digit_max = 1 << (p.ks_base_log - 1)
        self.limb_bits = max(1, min(32, 52 - (digit_max * S).bit_length()))
        ksk = keys.ksk.reshape(S, p.n + 1)
        mask = (1 << self.limb_bits) - 1
        self.ksk_limbs = [((ksk >> s) & mask).to(torch.float64)
                          for s in range(0, 64, self.limb_bits)]

    def keyswitch(self, cts: torch.Tensor) -> torch.Tensor:
        p = self.params
        digits = decompose(cts[:, :-1], p.ks_base_log, p.ks_level)
        digits = digits.reshape(cts.shape[0], -1).to(torch.float64)
        acc = torch.zeros((cts.shape[0], p.n + 1), dtype=I64, device=cts.device)
        for t, limb in enumerate(self.ksk_limbs):
            part = torch.round(digits @ limb).to(I64)
            acc += part << (self.limb_bits * t)
        out = -acc
        out[:, -1] += cts[:, -1]
        return out

    def blind_rotate(self, lut_polys: torch.Tensor, small: torch.Tensor) -> torch.Tensor:
        p = self.params
        N, log2_2N = p.N, p.N.bit_length()
        shift = 64 - log2_2N
        ms = (((small >> (shift - 1)) & ((1 << (log2_2N + 1)) - 1)) + 1) >> 1
        ms = ms & ((1 << log2_2N) - 1)
        a, b = ms[:, :-1], ms[:, -1]
        acc = torch.zeros((small.shape[0], p.k + 1, N), dtype=I64, device=small.device)
        acc[:, p.k] = lut_polys
        acc = rotate(acc, (2 * N - b) % (2 * N), N)
        for i in range(p.n):
            diff = rotate(acc, a[:, i], N) - acc
            dig = decompose(diff, p.pbs_base_log, p.pbs_level)
            dig_f = fold_fft(dig.movedim(-1, -2).to(self.dtype))
            out_f = torch.einsum("bulf,ulcf->bcf", dig_f, self.bsk_f[i])
            acc = acc + float_to_torus(unfold_ifft(out_f))
        return acc

    def lut_batch(self, cts: torch.Tensor, lut_polys: torch.Tensor) -> torch.Tensor:
        return self.lut_batch_small(self.keyswitch(cts), lut_polys)

    def lut_batch_small(self, small: torch.Tensor, lut_polys: torch.Tensor) -> torch.Tensor:
        """Blind rotation and sample extract of key-switched rows."""
        acc = self.blind_rotate(lut_polys, small)
        p = self.params
        a, body = acc[:, :p.k], acc[:, p.k]
        rev = -a.flip(-1)
        ext = torch.cat([a[..., :1], rev[..., :p.N - 1]], dim=-1).reshape(acc.shape[0], -1)
        return torch.cat([ext, body[:, :1]], dim=-1)



def install(engine, keys: ClientKeys, dtype=torch.float64) -> "ReferencePbs":
    """Put the reference PBS in the engine's place."""
    ref = ReferencePbs(keys, dtype)
    engine.lut_batch = ref.lut_batch
    engine.keyswitch = ref.keyswitch
    engine.lut_batch_small = ref.lut_batch_small
    return ref
