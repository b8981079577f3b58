"""GGSW ciphertexts, the bootstrapping key, and the external product.

A GGSW ciphertext of a bit s is a ((k+1)*level, k+1, N) stack of GLWE
rows:  row (u, l) = GLWE_sk(0) + s * g_l * e_u   (Z + s*G).

The external product  GGSW ⊡ GLWE -> GLWE  (paper Fig. 4b) is a
vector-matrix product over polynomials in the transform domain.  This
module is the complex128 reference path; the engine's `"fused"` backend
runs the same product through the hand-written kernels in
`repro_torch.kernels.fused_pbs`.
"""
from __future__ import annotations

import torch

from repro_torch.core import fft, glwe, torus, decompose as dec
from repro_torch.core.params import TFHEParams

I64 = torch.int64


def _gadget(base_log: int, level: int, device) -> torch.Tensor:
    """g_l = 2^(64 - (l+1)*base_log), l < level, as int64 bits."""
    return torch.tensor([torus.as_i64(1 << (64 - base_log * l))
                         for l in range(1, level + 1)], dtype=I64, device=device)


def encrypt_bits(generator: torch.Generator, sk: torch.Tensor,
                 bits: torch.Tensor, base_log: int, level: int,
                 std: float) -> torch.Tensor:
    """GGSWs of a vector of bits: (n,) -> (n, k+1, level, k+1, N) int64."""
    k, N = sk.shape
    n = bits.shape[0]
    rows_msg = torch.zeros((n, (k + 1) * level, N), dtype=I64, device=sk.device)
    z = glwe.encrypt(generator, sk, rows_msg, std)     # (n, (k+1)*level, k+1, N)
    z = z.reshape(n, k + 1, level, k + 1, N)
    add = bits.to(I64)[:, None] * _gadget(base_log, level, sk.device)  # (n, level)
    # row (u, l) gets + s*g_l on the constant monomial of its u-th polynomial
    for u in range(k + 1):
        z[:, u, :, u, 0] += add
    return z


def encrypt_bit(generator: torch.Generator, sk: torch.Tensor, bit,
                base_log: int, level: int, std: float) -> torch.Tensor:
    """GGSW of a single bit: (k+1, level, k+1, N) int64."""
    bits = torch.as_tensor(bit, dtype=I64, device=sk.device).reshape(1)
    return encrypt_bits(generator, sk, bits, base_log, level, std)[0]


def bsk_gen(generator: torch.Generator, lwe_sk: torch.Tensor,
            glwe_sk: torch.Tensor, params: TFHEParams) -> torch.Tensor:
    """Bootstrapping key: n GGSW ciphertexts of the small-LWE key bits.

    Returns (n, k+1, level, k+1, N) int64.
    """
    return encrypt_bits(generator, glwe_sk, lwe_sk, params.pbs_base_log,
                        params.pbs_level, params.glwe_std)


def bsk_to_fourier(bsk: torch.Tensor) -> torch.Tensor:
    """Pre-transform the BSK once (complex128 (n, k+1, level, k+1, N/2)).

    This is the stream the paper's BRU reads from HBM; in the batched
    engine it is the reused operand (key-reuse strategy, §III-B).
    """
    return fft.forward(bsk)


def external_product_fourier(ggsw_f: torch.Tensor, glwe_ct: torch.Tensor,
                             base_log: int, level: int) -> torch.Tensor:
    """GGSW (fourier, (k+1, level, k+1, N/2)) ⊡ GLWE ((..., k+1, N)) -> GLWE."""
    digits = dec.decompose(glwe_ct, base_log, level)     # (..., k+1, N, level)
    dig_f = fft.forward(digits.movedim(-1, -2))          # (..., k+1, level, N/2)
    out_f = torch.einsum("...ulf,ulcf->...cf", dig_f, ggsw_f)
    return fft.inverse_torus(out_f)


def cmux_fourier(ggsw_f: torch.Tensor, ct0: torch.Tensor, ct1: torch.Tensor,
                 base_log: int, level: int) -> torch.Tensor:
    """CMux: returns ct0 if the GGSW bit is 0 else ct1."""
    return ct0 + external_product_fourier(ggsw_f, ct1 - ct0, base_log, level)
