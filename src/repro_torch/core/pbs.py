"""Programmable bootstrapping, key-switching-FIRST order (paper §II-B).

Pipeline (paper Fig. 3):  A key-switch -> B mod-switch -> C blind rotation
-> D sample extract.  Ciphertexts between PBS ops live under the BIG key
(dimension k*N); key-switch brings them down to the small key (dimension
n) right before blind rotation.

`TFHEContext` bundles keygen + client ops; `pbs()` is the server op on
one ciphertext.  The batched variants live in `repro_torch.core.batch`
(plain PyTorch) and `repro_torch.kernels.fused_pbs` (hand-written CUDA
kernels); `TaurusEngine` selects between them via `kernel_backend`.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import torus, glwe, ggsw, lwe
from repro_torch.core.params import TFHEParams
from repro_torch.device import resolve_device

I64 = torch.int64


def blind_rotate(lut_glwe: torch.Tensor, lwe_ct_mod: torch.Tensor,
                 bsk_f: torch.Tensor, params: TFHEParams) -> torch.Tensor:
    """Blind rotation (paper step C).

    lut_glwe: (k+1, N) trivial/encrypted GLWE holding the LUT.
    lwe_ct_mod: (n+1,) int64 values already mod-switched into [0, 2N).
    bsk_f: (n, k+1, level, k+1, N/2) fourier BSK.
    """
    N = params.N
    a, b = lwe_ct_mod[:-1], lwe_ct_mod[-1]
    acc = glwe.rotate(lut_glwe, (2 * N - b) % (2 * N), N)   # X^{-b} * V
    for a_i, bsk_i in zip(a, bsk_f):
        rotated = glwe.rotate(acc, a_i, N)                  # X^{a_i} * acc
        acc = ggsw.cmux_fourier(bsk_i, acc, rotated, params.pbs_base_log,
                                params.pbs_level)
    return acc


def pbs(big_ct: torch.Tensor, lut_poly: torch.Tensor, bsk_f: torch.Tensor,
        ksk: torch.Tensor, params: TFHEParams) -> torch.Tensor:
    """One full PBS: (k*N+1,) LWE + (N,) LUT poly -> (k*N+1,) LWE."""
    small = lwe.keyswitch(big_ct, ksk, params.ks_base_log, params.ks_level)
    ms = lwe.mod_switch(small, params.log2_N + 1)
    acc = blind_rotate(glwe.trivial(lut_poly, params.k), ms, bsk_f, params)
    return glwe.sample_extract(acc)


@dataclasses.dataclass
class TFHEContext:
    """Client-side key material + encode/encrypt helpers (Fig. 1 client)."""
    params: TFHEParams
    lwe_sk: torch.Tensor      # small key (n,)
    glwe_sk: torch.Tensor     # (k, N)
    big_sk: torch.Tensor      # flattened GLWE key (k*N,)
    bsk_f: torch.Tensor       # fourier bootstrapping key (server/eval key)
    ksk: torch.Tensor         # key-switching key big->small (server/eval key)

    @classmethod
    def create(cls, generator: torch.Generator, params: TFHEParams,
               device=None) -> "TFHEContext":
        """Keygen from `generator`, which must live on `device` (the card
        unless the caller names another device)."""
        device = resolve_device(device)
        if generator.device.type != device.type:
            raise ValueError(f"generator is on {generator.device}, keys go "
                             f"to {device}")
        lwe_sk = lwe.keygen(generator, params.n, device)
        glwe_sk = glwe.keygen(generator, params.k, params.N, device)
        big_sk = glwe.flatten_key(glwe_sk)
        bsk_f = ggsw.bsk_to_fourier(ggsw.bsk_gen(generator, lwe_sk, glwe_sk, params))
        ksk = lwe.ksk_gen(generator, big_sk, lwe_sk, params.ks_base_log,
                          params.ks_level, params.lwe_std)
        return cls(params, lwe_sk, glwe_sk, big_sk, bsk_f, ksk)

    @property
    def device(self) -> torch.device:
        return self.big_sk.device

    # -- client ops ------------------------------------------------------
    def encrypt(self, generator: torch.Generator, msg) -> torch.Tensor:
        """Encrypt integer message(s) under the BIG key (PBS-ready)."""
        m = torus.encode(msg, self.params.delta, device=self.device)
        return lwe.encrypt(generator, self.big_sk, m, self.params.glwe_std)

    def decrypt(self, ct: torch.Tensor) -> torch.Tensor:
        ph = lwe.decrypt_phase(self.big_sk, ct)
        return torus.decode(ph, self.params.delta, self.params.plaintext_modulus)

    def decrypt_noise(self, ct: torch.Tensor, msg) -> torch.Tensor:
        """Signed residual noise (torus units) for noise-budget tests."""
        ph = lwe.decrypt_phase(self.big_sk, ct)
        expect = torus.encode(msg, self.params.delta, device=self.device)
        return (ph - expect).to(torch.float64) / 2.0 ** 64

    # -- server op ---------------------------------------------------------
    def lut(self, ct: torch.Tensor, table) -> torch.Tensor:
        poly = glwe.make_lut_poly(table, self.params, device=self.device)
        return pbs(ct, poly, self.bsk_f, self.ksk, self.params)
