"""LWE ciphertexts and the LPU-side operations (paper §IV-A).

Ciphertext layout: (..., n+1) int64 = [a_0 .. a_{n-1}, b], the bits of
the reference's uint64 torus values.  All functions are batched over
leading axes.  Randomness comes from an explicit `torch.Generator`,
whose device decides where new tensors live.

`keyswitch` here is the plain path; the engine's `"fused"` backend runs
the hand-written CUDA MAC in `repro_torch.kernels.keyswitch`, which is
bit-identical to it.
"""
from __future__ import annotations

import torch

from repro_torch.core import torus, decompose as dec

I64 = torch.int64

# Rows of S per partial product on CUDA, where torch has no int64 matmul:
# B x 2048 x T int64 is about 200 MB at the paper's gpt2 shapes.
_MUL_SUM_CHUNK = 2048


# --- keys & encryption (client side; the server never holds these) ----------

def keygen(generator: torch.Generator, n: int, device=None) -> torch.Tensor:
    """Binary LWE secret key, shape (n,) int64 in {0,1}."""
    return torch.randint(0, 2, (n,), dtype=I64, generator=generator,
                         device=device)


def encrypt(generator: torch.Generator, sk: torch.Tensor,
            msg_torus: torch.Tensor, std: float) -> torch.Tensor:
    """Encrypt torus element(s).  msg_torus: (...,) int64 -> (..., n+1)."""
    n = sk.shape[0]
    shape = tuple(msg_torus.shape)
    a = torus.random_torus(generator, shape + (n,), device=sk.device)
    e = torus.gaussian_noise(generator, shape, std, device=sk.device)
    b = (a * sk).sum(dim=-1) + msg_torus + e
    return torch.cat([a, b[..., None]], dim=-1)


def decrypt_phase(sk: torch.Tensor, ct: torch.Tensor) -> torch.Tensor:
    """Return the noisy phase b - <a, s>  (caller rounds/decodes)."""
    return ct[..., -1] - (ct[..., :-1] * sk).sum(dim=-1)


def trivial(msg_torus: torch.Tensor, n: int) -> torch.Tensor:
    """Noiseless 'trivial' ciphertext (a=0, b=m) — public constant."""
    z = torch.zeros(tuple(msg_torus.shape) + (n,), dtype=I64,
                    device=msg_torus.device)
    return torch.cat([z, msg_torus[..., None].to(I64)], dim=-1)


# --- linear homomorphic ops (LPU VecAdd / VecMult) ---------------------------

def add(ct0: torch.Tensor, ct1: torch.Tensor) -> torch.Tensor:
    return ct0 + ct1  # int64 wraparound == torus addition


def sub(ct0: torch.Tensor, ct1: torch.Tensor) -> torch.Tensor:
    return ct0 - ct1


def scalar_mul(ct: torch.Tensor, c) -> torch.Tensor:
    """Multiply by a plaintext (small) integer."""
    return ct * torch.as_tensor(c, dtype=I64, device=ct.device)


def add_plain(ct: torch.Tensor, msg_torus) -> torch.Tensor:
    out = ct.clone()
    out[..., -1] += torch.as_tensor(msg_torus, dtype=I64, device=ct.device)
    return out


# --- modulus switching (paper step B) ----------------------------------------

def mod_switch(ct: torch.Tensor, log2_2N: int) -> torch.Tensor:
    """Scale torus values from q=2^64 to Z_{2N}; returns int64 in [0, 2N)."""
    shift = 64 - log2_2N
    rounded = torus.srl(ct, shift - 1) + 1
    return (rounded >> 1) & ((1 << log2_2N) - 1)


# --- key switching (paper step A; KS-first order) -----------------------------

def ksk_gen(generator: torch.Generator, sk_from: torch.Tensor,
            sk_to: torch.Tensor, base_log: int, level: int,
            std: float) -> torch.Tensor:
    """Key-switching key: (n_from, level, n_to+1) int64.

    KSK[i, l] = LWE_{sk_to}( sk_from[i] * g_l ),  g_l = 2^(64-(l+1)*base_log)
    """
    g = torch.tensor([torus.as_i64(1 << (64 - base_log * l))
                      for l in range(1, level + 1)], dtype=I64,
                     device=sk_from.device)
    msgs = sk_from[:, None] * g[None, :]           # (n_from, level)
    return encrypt(generator, sk_to, msgs, std)


def wrapping_matmul(d: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """(..., S) @ (S, T) in int64, wrapping mod 2^64.

    On the CPU this is torch's int64 matmul, which wraps.  CUDA has no
    int64 matmul, so there it is a multiply-and-sum over chunks of S (one
    broadcast over the whole of S would be 19 GB at the gpt2 shapes)."""
    if d.device.type == "cpu":
        return d @ k
    S = d.shape[-1]
    acc = torch.zeros(tuple(d.shape[:-1]) + (k.shape[-1],), dtype=I64,
                      device=d.device)
    for s0 in range(0, S, _MUL_SUM_CHUNK):
        s1 = min(S, s0 + _MUL_SUM_CHUNK)
        acc += (d[..., s0:s1, None] * k[s0:s1]).sum(dim=-2)
    return acc


def keyswitch(ct: torch.Tensor, ksk: torch.Tensor, base_log: int,
              level: int) -> torch.Tensor:
    """Switch (..., n_from+1) under sk_from to (..., n_to+1) under sk_to."""
    n_from, _, t = ksk.shape
    digits = dec.decompose(ct[..., :-1], base_log, level)  # (..., n_from, level)
    acc = wrapping_matmul(digits.flatten(-2), ksk.reshape(n_from * level, t))
    out = -acc
    out[..., -1] += ct[..., -1]
    return out
