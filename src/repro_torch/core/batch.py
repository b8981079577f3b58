"""Batched PBS in plain PyTorch — the engine's `"reference"` backend.

The paper round-robins 12 ciphertexts through one FFT pipeline so each
BSK chunk streamed from HBM is consumed by all in-flight ciphertexts.
Here the same idea is a batch dimension: each blind-rotation step reads
bsk_f[i] once and applies it to the whole batch in one einsum.  The
reference's `lax.scan` over the n steps is a Python loop.
"""
from __future__ import annotations

import torch

from repro_torch.core import decompose as dec, fft, glwe, lwe
from repro_torch.core.params import TFHEParams


def rotate_batch(cts: torch.Tensor, rs: torch.Tensor, N: int) -> torch.Tensor:
    """Monomial-rotate a batch, one shift per row: cts (B, k+1, N), rs (B,)
    in [0, 2N)."""
    idx, neg = glwe.rotation_index(rs, N)               # (B, N)
    vals = torch.gather(cts, -1, idx[:, None, :].expand_as(cts))
    return torch.where(neg[:, None, :], -vals, vals)


def external_product_batch(ggsw_f: torch.Tensor, glwe_cts: torch.Tensor,
                           base_log: int, level: int) -> torch.Tensor:
    """One GGSW (fourier) applied to a BATCH of GLWEs — the key-reuse MAC.

    ggsw_f: (k+1, level, k+1, N/2) complex — read once for the batch.
    glwe_cts: (B, k+1, N) int64.
    """
    digits = dec.decompose(glwe_cts, base_log, level)   # (B, k+1, N, level)
    dig_f = fft.forward(digits.movedim(-1, -2))         # (B, k+1, level, N/2)
    out_f = torch.einsum("bulf,ulcf->bcf", dig_f, ggsw_f)
    return fft.inverse_torus(out_f)


def blind_rotate_batch(lut_glwes: torch.Tensor, ms_cts: torch.Tensor,
                       bsk_f: torch.Tensor, params: TFHEParams) -> torch.Tensor:
    """Batched blind rotation.

    lut_glwes: (B, k+1, N); ms_cts: (B, n+1) mod-switched to [0, 2N);
    bsk_f: (n, k+1, level, k+1, N/2) — walked once, shared across batch.
    """
    N = params.N
    a, b = ms_cts[:, :-1], ms_cts[:, -1]
    acc = rotate_batch(lut_glwes, (2 * N - b) % (2 * N), N)
    for a_i, bsk_i in zip(a.T, bsk_f):
        diff = rotate_batch(acc, a_i, N) - acc
        acc = acc + external_product_batch(bsk_i, diff, params.pbs_base_log,
                                           params.pbs_level)
    return acc


def keyswitch_batch(big_cts: torch.Tensor, ksk: torch.Tensor,
                    params: TFHEParams) -> torch.Tensor:
    """(B, k*N+1) -> (B, n+1); one wrapping int64 product (LPU)."""
    return lwe.keyswitch(big_cts, ksk, params.ks_base_log, params.ks_level)


def pbs_batch_small(small_cts: torch.Tensor, lut_polys: torch.Tensor,
                    bsk_f: torch.Tensor, params: TFHEParams) -> torch.Tensor:
    """PBS minus the keyswitch: (B, n+1) small-key cts + (B, N) LUTs ->
    (B, k*N+1).  `keyswitch_batch` then this function computes exactly
    what `pbs_batch` computes."""
    ms = lwe.mod_switch(small_cts, params.log2_N + 1)
    acc = blind_rotate_batch(glwe.trivial(lut_polys, params.k), ms, bsk_f,
                             params)
    return glwe.sample_extract(acc)


def pbs_batch(big_cts: torch.Tensor, lut_polys: torch.Tensor,
              bsk_f: torch.Tensor, ksk: torch.Tensor,
              params: TFHEParams) -> torch.Tensor:
    """Batch of full PBS ops: (B, k*N+1) + (B, N) LUTs -> (B, k*N+1)."""
    return pbs_batch_small(keyswitch_batch(big_cts, ksk, params), lut_polys,
                           bsk_f, params)


def pbs_unbatched_loop(big_cts: torch.Tensor, lut_polys: torch.Tensor,
                       bsk_f: torch.Tensor, ksk: torch.Tensor,
                       params: TFHEParams) -> torch.Tensor:
    """XPU-style baseline: process ciphertexts one at a time (no BSK
    reuse across ciphertexts) through `core.pbs.pbs`.  Same math, B x the
    BSK traffic — the paper's Table IV comparison."""
    from repro_torch.core import pbs as pbs_mod
    return torch.stack([pbs_mod.pbs(ct, lut, bsk_f, ksk, params)
                        for ct, lut in zip(big_cts, lut_polys)])
