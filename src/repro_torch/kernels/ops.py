"""Public wrappers over the four kernels, with the reference's names,
signatures and defaults: the port of `repro.kernels.ops`.

`dtype` selects the transform-plane precision: f32 is the reference's
default (the TPU-native mode), f64 is what the fused engine path runs.
The keyswitch MAC is exact mod 2^64 for any int32 digits.

Each wrapper runs on its tensors' device: the CUDA kernels for CUDA
tensors (a kernel that fails to build or launch raises), the plain
PyTorch versions only for CPU tensors.  `block_f` and `block_s` are the
TPU kernels' tiling hints: the CUDA kernels choose their own tiles, so
the hints are validated as the reference validates them and otherwise
change nothing in the result.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import external_product, fourstep_fft, keyswitch

MAX_BLOCK_S = 4096      # the reference's largest keyswitch block


def negacyclic_fft(x: torch.Tensor, *, dtype=torch.float32) -> torch.Tensor:
    """Forward negacyclic transform, (B, N) real -> (B, 2, N/2) planes."""
    return fourstep_fft.fft_forward(x, dtype)


def negacyclic_ifft(spec: torch.Tensor, *, dtype=torch.float32) -> torch.Tensor:
    """(B, 2, M) -> (B, 2M) plane-dtype coefficients."""
    return fourstep_fft.fft_inverse(spec, dtype)


def bru_mac(dig: torch.Tensor, bsk: torch.Tensor, *, block_f: int = 2048,
            dtype=torch.float32) -> torch.Tensor:
    """Blind-rotation MAC: (B,2,J,F) x (2,J,K,F) -> (B,2,K,F).  F must be
    a multiple of min(block_f, F), as the reference's grid requires."""
    F_ = dig.shape[-1]
    bf = min(block_f, F_)
    if bf < 1 or F_ % bf:
        raise ValueError(f"bru_mac: F = {F_} is not a multiple of the block {bf}")
    return external_product.external_product_mac(dig, bsk, dtype)


def lpu_keyswitch_mac(digits: torch.Tensor, ksk_u64: torch.Tensor,
                      *, block_s: int = 1024) -> torch.Tensor:
    """digits (B,S) int32 x ksk (S,T) uint64 bits as int64 -> (B,T) int64
    (mod 2^64).  S is zero-padded up to a multiple of min(block_s, S), as
    the reference pads: zero digits add nothing."""
    S = digits.shape[1]
    bs = min(block_s, S)
    if bs < 1 or bs > MAX_BLOCK_S:
        raise ValueError(f"lpu_keyswitch_mac: block {bs} is not in [1, {MAX_BLOCK_S}]")
    pad = (-S) % bs
    if pad:
        digits = F.pad(digits, (0, pad))
        ksk = F.pad(ksk_u64, (0, 0, 0, pad))
    else:
        ksk = ksk_u64
    return keyswitch.keyswitch_mac_int32(digits.to(torch.int32), ksk)
