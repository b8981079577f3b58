"""The client side of a TFHE deployment, in plain PyTorch.

A client makes its secret keys and the evaluation keys it hands to the
server, encrypts its messages under the big (GLWE-flattened) key and
decrypts what comes back.  Everything here is drawn from one seeded
`torch.Generator` on the device in a few large calls, and nothing here
imports the program under test: the benchmark's decryptions and noise
readings do not depend on the program's own key or encoding code.

Torus values are 64-bit, carried as the bits of int64 (additions and
products wrap mod 2^64).  The bootstrapping key is made with EXACT
negacyclic products: each 64-bit mask polynomial is split into four
16-bit limbs, whose products with the binary key stay below 2^31 and
round exactly out of a float64 FFT.
"""
from __future__ import annotations

import dataclasses
import math

import torch

I64 = torch.int64
LIMB_BITS = 16
CHUNK = 256            # GLWE ciphertexts per batch of FFT products


def as_i64(x: int) -> int:
    """A Python integer mod 2^64 as the int64 with the same bits."""
    x &= (1 << 64) - 1
    return x - (1 << 64) if x >= 1 << 63 else x


@dataclasses.dataclass(frozen=True)
class Params:
    """A TFHE parameter set as the configuration file states it."""
    n: int
    N: int
    k: int
    width: int
    pbs_base_log: int
    pbs_level: int
    ks_base_log: int
    ks_level: int
    lwe_std: float
    glwe_std: float
    padding_bits: int = 1

    @property
    def big_n(self) -> int:
        return self.k * self.N

    @property
    def delta(self) -> int:
        return 1 << (64 - self.width - self.padding_bits)

    @property
    def modulus(self) -> int:
        return 1 << self.width


def random_torus(gen: torch.Generator, shape) -> torch.Tensor:
    """Uniform 64-bit values from two 32-bit draws."""
    kw = dict(dtype=I64, generator=gen, device=gen.device)
    hi = torch.randint(0, 1 << 32, tuple(shape), **kw)
    lo = torch.randint(0, 1 << 32, tuple(shape), **kw)
    return hi * (1 << 32) + lo


def gaussian(gen: torch.Generator, shape, std: float) -> torch.Tensor:
    """Rounded Gaussian noise of `std` torus units, as int64."""
    e = torch.randn(tuple(shape), dtype=torch.float64, generator=gen,
                    device=gen.device) * (std * 2.0 ** 64)
    return torch.round(e).to(I64)


def _twist(N: int, device) -> torch.Tensor:
    j = torch.arange(N // 2, dtype=torch.float64, device=device)
    return torch.polar(torch.ones_like(j), math.pi * j / N)


def fold_fft(x: torch.Tensor) -> torch.Tensor:
    """Real (..., N) float -> the (..., N/2) spectrum whose pointwise
    products are negacyclic convolutions, in x's precision."""
    N = x.shape[-1]
    u = torch.complex(x[..., : N // 2], x[..., N // 2:])
    return torch.fft.fft(u * _twist(N, x.device).to(u.dtype), dim=-1)


def unfold_ifft(spec: torch.Tensor) -> torch.Tensor:
    """The inverse of `fold_fft`: (..., N/2) spectrum -> real (..., N)."""
    N = spec.shape[-1] * 2
    u = torch.fft.ifft(spec, dim=-1) * torch.conj(_twist(N, spec.device)).to(spec.dtype)
    return torch.cat([u.real, u.imag], dim=-1)


def negacyclic_mul_binary(a: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """Exact sum_i a_i * s_i in Z_{2^64}[X]/(X^N+1).

    a: (..., k, N) int64 torus polynomials; s: (k, N) binary key.  Each
    16-bit limb's product with s has coefficients below 2^31 in
    magnitude, so one float64 FFT product rounds to it exactly."""
    s_f = fold_fft(s.to(torch.float64))
    out = torch.zeros(a.shape[:-2] + a.shape[-1:], dtype=I64, device=a.device)
    for t in range(64 // LIMB_BITS):
        limb = ((a >> (LIMB_BITS * t)) & ((1 << LIMB_BITS) - 1)).to(torch.float64)
        prod = unfold_ifft((fold_fft(limb) * s_f).sum(dim=-2))
        out += torch.round(prod).to(I64) * as_i64(1 << (LIMB_BITS * t))
    return out


@dataclasses.dataclass
class ClientKeys:
    """A client's secret keys and the evaluation keys it gives the
    server (the bootstrapping key in the coefficient domain)."""
    params: Params
    lwe_sk: torch.Tensor      # (n,) binary
    glwe_sk: torch.Tensor     # (k, N) binary
    big_sk: torch.Tensor      # (k*N,) binary
    bsk: torch.Tensor         # (n, k+1, level, k+1, N) int64
    ksk: torch.Tensor         # (k*N, ks_level, n+1) int64


def gadget(base_log: int, level: int, device) -> torch.Tensor:
    return torch.tensor([as_i64(1 << (64 - base_log * l)) for l in range(1, level + 1)],
                        dtype=I64, device=device)


def keygen(p: Params, gen: torch.Generator) -> ClientKeys:
    """Secret keys, the key-switching key (big key -> small key) and the
    bootstrapping key (GGSWs of the small key's bits), all from `gen`."""
    dev = gen.device
    lwe_sk = torch.randint(0, 2, (p.n,), dtype=I64, generator=gen, device=dev)
    glwe_sk = torch.randint(0, 2, (p.k, p.N), dtype=I64, generator=gen, device=dev)
    big_sk = glwe_sk.reshape(-1)
    # KSK[i, l] = LWE_{lwe_sk}(big_sk[i] * g_l)
    msgs = big_sk[:, None] * gadget(p.ks_base_log, p.ks_level, dev)[None, :]
    ksk = lwe_encrypt(gen, lwe_sk, msgs, p.lwe_std)
    # BSK[i] row (u, l) = GLWE(0) + lwe_sk[i] * g_l on polynomial u's constant
    rows = p.n * (p.k + 1) * p.pbs_level
    bsk = torch.empty((rows, p.k + 1, p.N), dtype=I64, device=dev)
    for r0 in range(0, rows, CHUNK):
        r1 = min(rows, r0 + CHUNK)
        a = random_torus(gen, (r1 - r0, p.k, p.N))
        e = gaussian(gen, (r1 - r0, p.N), p.glwe_std)
        bsk[r0:r1, :p.k] = a
        bsk[r0:r1, p.k] = negacyclic_mul_binary(a, glwe_sk) + e
    bsk = bsk.reshape(p.n, p.k + 1, p.pbs_level, p.k + 1, p.N)
    add = lwe_sk[:, None] * gadget(p.pbs_base_log, p.pbs_level, dev)[None, :]
    for u in range(p.k + 1):
        bsk[:, u, :, u, 0] += add
    return ClientKeys(p, lwe_sk, glwe_sk, big_sk, bsk, ksk)


def lwe_encrypt(gen: torch.Generator, sk: torch.Tensor, msg_torus: torch.Tensor,
                std: float) -> torch.Tensor:
    """(...,) torus messages -> (..., len(sk)+1) LWE ciphertexts."""
    shape = tuple(msg_torus.shape)
    a = random_torus(gen, shape + (sk.shape[0],))
    b = (a * sk).sum(dim=-1) + msg_torus + gaussian(gen, shape, std)
    return torch.cat([a, b[..., None]], dim=-1)


def encrypt(keys: ClientKeys, gen: torch.Generator, messages) -> torch.Tensor:
    """Integer messages (R,) -> (R, k*N+1) ciphertexts under the big key."""
    p = keys.params
    m = torch.as_tensor(messages, dtype=I64, device=gen.device) * as_i64(p.delta)
    return lwe_encrypt(gen, keys.big_sk, m, p.glwe_std)


def phase(keys: ClientKeys, cts: torch.Tensor) -> torch.Tensor:
    return cts[..., -1] - (cts[..., :-1] * keys.big_sk).sum(dim=-1)


def decrypt(keys: ClientKeys, cts: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(R, k*N+1) -> (messages mod 2^width, signed phase int64)."""
    p = keys.params
    ph = phase(keys, cts)
    shift = p.delta.bit_length() - 1
    rounded = ((ph + (p.delta >> 1)) >> shift) & ((1 << (64 - shift)) - 1)
    return rounded % p.modulus, ph


def noise_share(keys: ClientKeys, ph: torch.Tensor, expect) -> torch.Tensor:
    """|phase - expect * delta| as a share of half a message slot: below 1
    the ciphertext decrypts to `expect`."""
    p = keys.params
    want = torch.as_tensor(expect, dtype=I64, device=ph.device) * as_i64(p.delta)
    return (ph - want).to(torch.float64).abs() / (p.delta / 2)
