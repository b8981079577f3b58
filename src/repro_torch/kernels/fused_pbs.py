"""The fused PBS path: the hand-written kernels wired into one hot path.

This is what `TaurusEngine(kernel_backend="fused")` runs: the batched
KS-first PBS (paper Fig. 3, steps A-D) with the paper's key reuse made
explicit as RESIDENT operands.

    keyswitch     `kernels.keyswitch` — the 64-bit MAC over the int8 gadget
                  digits of the whole batch as one int8 tensor-core GEMM
                  against the KSK's byte limbs, bit-identical to
                  `core.lwe.keyswitch`.
    blind rotate  per step, three launches: the forward FFT kernel takes
                  the rotate, subtract and decompose of the CMux
                  difference; one MAC kernel against the resident BSK
                  slice; the inverse FFT kernel rounds back onto the
                  torus and adds the accumulator.
    extract       `core.glwe.sample_extract`.

`FusedPbsPack` is the residency contract: the Fourier BSK is laid out in
the MAC kernel's re/im plane layout ONCE per key, and the KSK in the
keyswitch kernel's limb operand (`keyswitch.ksk_limbs`: its bytes,
K-major, (8T, S16) uint8, as much memory again as the int64 key, which
the reference engine keeps), and every later round reads the same
device tensors.  The pack is f64 only (an f32 transform voids
decryption on the 64-bit torus), and the TPU's tiling knobs (`block_f`,
`block_s`, `interpret`) have no counterpart here.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import batch as batch_mod, decompose as dec, glwe, lwe
from repro_torch.core.params import TFHEParams
from repro_torch.kernels import external_product, fourstep_fft, keyswitch


def bsk_to_planes(bsk_f: torch.Tensor) -> torch.Tensor:
    """Fourier BSK (n, k+1, level, k+1, M) complex -> kernel plane layout
    (n, 2, J, K, M) f64 with J = (k+1)*level rows, j = u*level + l, the
    order `external_product_planes` decomposes into."""
    n, kp1, level, _, M = bsk_f.shape
    flat = bsk_f.reshape(n, kp1 * level, kp1, M)
    return torch.stack([flat.real, flat.imag], dim=1).contiguous()


def keyswitch_fused(big_cts: torch.Tensor, ksk_limbs: torch.Tensor,
                    params: TFHEParams) -> torch.Tensor:
    """(B, big_n+1) -> (B, n+1) through the MAC kernel; `ksk_limbs` is
    the (S, n+1) int64 key with S = big_n * ks_level as the limb operand
    of `keyswitch.ksk_limbs`.  Bit-identical to `lwe.keyswitch`."""
    if params.ks_base_log > 8:
        raise ValueError(f"keyswitch_fused: ks_base_log {params.ks_base_log} > 8, "
                         "the digits do not fit int8")
    digits = dec.decompose(big_cts[:, :-1], params.ks_base_log, params.ks_level)
    digits = digits.reshape(big_cts.shape[0], -1).to(torch.int8)
    out = -keyswitch.keyswitch_mac(digits, ksk_limbs)
    out[:, -1] += big_cts[:, -1]
    return out


def external_product_planes(bsk_i: torch.Tensor, glwe_cts: torch.Tensor,
                            params: TFHEParams) -> torch.Tensor:
    """One resident BSK slice (2, J, K, M) applied to a GLWE batch
    (B, K, N): the digits' forward transforms, the MAC, the inverse
    transform back onto the torus (three launches)."""
    dig = fourstep_fft.fft_forward_digits(glwe_cts, None, params.pbs_base_log,
                                          params.pbs_level)
    out = external_product.external_product_mac(dig, bsk_i)      # (B, 2, K, M)
    return fourstep_fft.fft_inverse_torus(out, None)


def blind_rotate_fused(lut_glwes: torch.Tensor, ms_cts: torch.Tensor,
                       bsk_planes: torch.Tensor, params: TFHEParams) -> torch.Tensor:
    """Batched blind rotation over the RESIDENT plane-layout BSK.

    lut_glwes (B, k+1, N); ms_cts (B, n+1) mod-switched to [0, 2N);
    bsk_planes (n, 2, J, K, M) — walked once, shared by the whole batch.
    Each CMux step is three launches: the digits of X^a_i * acc - acc
    through the forward transform, the MAC, and the inverse transform
    rounded onto the torus and added to acc.
    """
    N = params.N
    a, b = ms_cts[:, :-1], ms_cts[:, -1]
    acc = batch_mod.rotate_batch(lut_glwes, (2 * N - b) % (2 * N), N)
    for a_i, bsk_i in zip(a.T.contiguous(), bsk_planes):
        dig = fourstep_fft.fft_forward_digits(acc, a_i, params.pbs_base_log,
                                              params.pbs_level)
        out = external_product.external_product_mac(dig, bsk_i)
        acc = fourstep_fft.fft_inverse_torus(out, acc)
    return acc


def pbs_small_fused(small_cts: torch.Tensor, lut_polys: torch.Tensor,
                    bsk_planes: torch.Tensor, params: TFHEParams) -> torch.Tensor:
    """PBS minus the keyswitch: (B, n+1) small-key cts + (B, N) LUT polys
    -> (B, k*N+1)."""
    ms = lwe.mod_switch(small_cts, params.log2_N + 1)
    acc = blind_rotate_fused(glwe.trivial(lut_polys, params.k), ms,
                             bsk_planes, params)
    return glwe.sample_extract(acc)


def pbs_batch_fused(big_cts: torch.Tensor, lut_polys: torch.Tensor,
                    bsk_planes: torch.Tensor, ksk_limbs: torch.Tensor,
                    params: TFHEParams) -> torch.Tensor:
    """(B, k*N+1) + (B, N) LUT polys -> (B, k*N+1), all four PBS stages
    on the kernels with resident key operands."""
    return pbs_small_fused(keyswitch_fused(big_cts, ksk_limbs, params), lut_polys,
                           bsk_planes, params)


@dataclasses.dataclass
class FusedPbsPack:
    """Resident kernel operands for one evaluation-key pair, built once
    per engine and read by every later round."""
    params: TFHEParams
    bsk_planes: torch.Tensor         # (n, 2, J, K, M) f64 planes
    ksk_limbs: torch.Tensor          # (8T, S16) uint8, S = big_n * ks_level

    @classmethod
    def build(cls, bsk_f: torch.Tensor, ksk: torch.Tensor,
              params: TFHEParams) -> "FusedPbsPack":
        n_from, level, t = ksk.shape
        return cls(params, bsk_to_planes(bsk_f),
                   keyswitch.ksk_limbs(ksk.reshape(n_from * level, t)))

    # -- the engine entry points -------------------------------------------
    def pbs_batch(self, big_cts: torch.Tensor, lut_polys: torch.Tensor) -> torch.Tensor:
        return pbs_batch_fused(big_cts, lut_polys, self.bsk_planes, self.ksk_limbs,
                               self.params)

    def keyswitch(self, big_cts: torch.Tensor) -> torch.Tensor:
        return keyswitch_fused(big_cts, self.ksk_limbs, self.params)

    def blind_rotate(self, lut_glwes: torch.Tensor, ms_cts: torch.Tensor) -> torch.Tensor:
        return blind_rotate_fused(lut_glwes, ms_cts, self.bsk_planes, self.params)

    def pbs_from_small(self, small_cts: torch.Tensor,
                       lut_polys: torch.Tensor) -> torch.Tensor:
        """PBS resumed after `keyswitch`: the KS-level-dedup half-round."""
        return pbs_small_fused(small_cts, lut_polys, self.bsk_planes, self.params)

    # -- bandwidth accounting -------------------------------------------------
    @property
    def resident_key_bytes(self) -> tuple[int, int]:
        """(bsk_bytes, ksk_bytes) of the resident operands — what one
        fused round streams from device memory once, regardless of B
        (the KSK as its limb operand)."""
        return (self.bsk_planes.numel() * self.bsk_planes.element_size(),
                self.ksk_limbs.numel() * self.ksk_limbs.element_size())

    def bytes_streamed_per_round(self, batch: int) -> int:
        """Key-reuse traffic model of ONE fused round: the resident keys
        once, plus per-ciphertext input/LUT/output rows."""
        p = self.params
        bsk, ksk = self.resident_key_bytes
        per_ct = (2 * (p.big_n + 1) + p.N) * 8   # ct in + ct out + LUT poly
        return bsk + ksk + batch * per_ct
