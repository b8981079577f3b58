"""Torus arithmetic on q = 2^64, carried in int64 two's complement.

A torus element t in [0,1) is stored as round(t * 2^64) mod 2^64, viewed
as a signed int64.  Addition, subtraction and multiplication of int64
tensors wrap mod 2^64, so they are the torus ops unchanged.  PyTorch has
no unsigned 64-bit arithmetic, so the unsigned operations the reference
(`repro.core.torus`) uses are emulated here: a logical right shift is an
arithmetic shift followed by a mask (`srl`), and the unsigned `//` and
`%` of `decode` become a shift and a mask because delta is a power of two.
"""
from __future__ import annotations

import torch

I64 = torch.int64


def as_i64(x: int) -> int:
    """A Python integer mod 2^64 as the int64 value with the same bits."""
    x &= (1 << 64) - 1
    return x - (1 << 64) if x >= 1 << 63 else x


def srl(x: torch.Tensor, s: int) -> torch.Tensor:
    """Logical right shift of the 64-bit pattern of int64 `x` by s bits."""
    if s == 0:
        return x
    return (x >> s) & ((1 << (64 - s)) - 1)


def encode(msg, delta: int, device=None) -> torch.Tensor:
    """Integer message -> torus: m * delta mod q."""
    m = torch.as_tensor(msg, dtype=I64, device=device)
    return m * as_i64(delta)


def decode(t: torch.Tensor, delta: int, modulus: int) -> torch.Tensor:
    """Torus -> integer message: round(t / delta) mod message-modulus."""
    s = delta.bit_length() - 1
    assert delta == 1 << s, "decode needs a power-of-two delta"
    return srl(t + (delta >> 1), s) % modulus


def random_torus(generator: torch.Generator, shape, device=None) -> torch.Tensor:
    """Uniform 64-bit torus values from two 32-bit draws (`torch.randint`
    cannot span 2^64).  hi * 2^32 wraps like the shift it stands for."""
    kw = dict(dtype=I64, generator=generator, device=device)
    hi = torch.randint(0, 1 << 32, tuple(shape), **kw)
    lo = torch.randint(0, 1 << 32, tuple(shape), **kw)
    return hi * (1 << 32) + lo


def gaussian_noise(generator: torch.Generator, shape, std: float,
                   device=None) -> torch.Tensor:
    """Gaussian noise with std given in torus units, wrapped mod 2^64."""
    e = torch.randn(tuple(shape), dtype=torch.float64, generator=generator,
                    device=device) * (std * 2.0 ** 64)
    return torch.round(e).to(I64)


def float_to_torus(x: torch.Tensor) -> torch.Tensor:
    """Round a float64 tensor (|x| < 2^95) to int64 mod 2^64.

    Split into hi/lo parts in float space (both splits are exact f64
    ops), then wrap in integer space: hi * 2^32 is an int64 multiply,
    which wraps, where a shift of the float would lose the low bits.
    `torch.round` rounds half to even, as `jnp.round` does.
    """
    hi = torch.round(x / 2.0 ** 32)
    lo = x - hi * 2.0 ** 32
    return hi.to(I64) * (1 << 32) + torch.round(lo).to(I64)
