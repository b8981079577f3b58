"""Key-switch MAC: `acc[b, t] = sum_s d[b, s] * K[s, t] mod 2^64`.

Replaces the Pallas TPU kernel `repro/kernels/keyswitch.py::keyswitch_mac`
with the CUDA kernel in `csrc/keyswitch.cu`.  Hopper multiplies 64-bit
integers natively, so the TPU's uint32-limb synthesis is gone: the
kernel takes int32 digits and the int64 KSK itself and accumulates in
wrapping uint64, with S split across blocks and the partial sums
combined by atomic adds (exact, since wrapping addition ignores order).

Bound on the card: bytes — the KSK (1.58 GB at the gpt2 parameters) is
read once per round; the design keeps each block's digit rows on chip so
no KSK element is read twice.

`keyswitch_mac` launches the kernel for CUDA tensors and runs
`keyswitch_mac_plain` (a chunked int64 multiply-sum) only for CPU
tensors.
"""
from __future__ import annotations

import torch

from repro_torch.core import lwe
from repro_torch.kernels import _build


def keyswitch_mac_plain(digits: torch.Tensor, ksk: torch.Tensor) -> torch.Tensor:
    """digits (B, S) int32, ksk (S, T) int64 -> (B, T) int64 mod 2^64."""
    return lwe.wrapping_matmul(digits.to(torch.int64), ksk)


def keyswitch_mac(digits: torch.Tensor, ksk: torch.Tensor) -> torch.Tensor:
    """digits (B, S) int32, ksk (S, T) int64 -> (B, T) int64 mod 2^64."""
    if digits.device.type == "cpu":
        return keyswitch_mac_plain(digits, ksk)
    name = "keyswitch_mac"
    _build.require(name, digits.device.type == "cuda" and ksk.device == digits.device,
                   f"needs CUDA tensors on one device, got {digits.device} "
                   f"and {ksk.device}")
    _build.require(name, digits.dtype == torch.int32 and ksk.dtype == torch.int64,
                   f"needs int32 digits and an int64 key, got {digits.dtype} "
                   f"and {ksk.dtype}")
    _build.require(name, digits.dim() == 2 and ksk.dim() == 2
                   and digits.shape[1] == ksk.shape[0],
                   f"shapes {tuple(digits.shape)} x {tuple(ksk.shape)}")
    _build.require(name, digits.is_contiguous() and ksk.is_contiguous(),
                   "needs contiguous tensors")
    B, S = digits.shape
    T = ksk.shape[1]
    out = torch.zeros((B, T), dtype=torch.int64, device=digits.device)
    fn = _build.function("keyswitch", "keyswitch_mac_launch", 3, 3)
    _build.launch(name, fn, digits.data_ptr(), ksk.data_ptr(), out.data_ptr(),
                  B, S, T, device=digits.device)
    return out
