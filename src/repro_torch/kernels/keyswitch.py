"""Key-switch MAC: `acc[b, t] = sum_s d[b, s] * K[s, t] mod 2^64`.

Replaces the Pallas TPU kernel `repro/kernels/keyswitch.py::keyswitch_mac`
with the CUDA kernel in `csrc/keyswitch.cu`, on Hopper's int8 tensor
cores.  Each KSK word is eight little-endian bytes u_l, so

    acc[b, t] = sum_l 2^(8l) P_l[b, t]  (mod 2^64),
    P_l[b, t] = sum_s d[b, s] u_l[s, t],

and every P_l is an exact s8 x u8 -> s32 product over a stretch of at
most `STRETCH` rows of S (65,536 x 128 x 255 < 2^31), the tensor-core
form of the TPU kernel's 16-bit sub-limbs.  The key is stored once as
the K-major limb operand (`ksk_limbs`, (8T, S16) uint8, row 8t + l holds
byte l of column t), so the keyswitch is one int8 GEMM whose epilogue
folds each t's 8 limb rows into one wrapping uint64.

Bound on the card: the larger of the limb operand's bytes (1.58 GB at
the gpt2 parameters, read once per round) and 2 B S 8T int8 operations
at the tensor cores' peak; the kernel reads each limb byte once for all
rows of a round, with S split across blocks and the partial sums
combined by wrapping atomic adds (exact, since wrapping addition ignores
order).

`keyswitch_mac` launches the kernel for CUDA tensors and runs
`keyswitch_mac_plain`, which repeats the kernel's arithmetic (per-limb
products over stretches of S, then the shift-and-wrap fold), only for
CPU tensors.

The engine's digits fit int8 (ks_base_log <= 6).  The TPU kernel's
contract is the whole int32 range, which `keyswitch_mac_int32` keeps on
the same int8 kernel: each int32 digit is five balanced base-2^8 digits
d = sum_i 2^(8i) d_i, d_i in [-128, 127] (`split_int32`; four reach only
2,139,062,143), stacked along the batch, so one launch over 5B rows
against the one limb operand gives each d_i . K, and
sum_i 2^(8i) (d_i . K) = d . K mod 2^64 (`fold_int32`).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build

TILE_S = 16          # the limb operand's S is padded to a multiple of this
STRETCH = 65536      # rows of S whose int32 limb products stay exact
_PLAIN_CHUNK = 8192  # rows of S per float64 product in the plain version
_LIMB_SCALE = [1 << (8 * l) for l in range(8)]
INT32_DIGITS = 5     # balanced base-2^8 digits of an int32


def ksk_limbs(ksk: torch.Tensor) -> torch.Tensor:
    """(S, T) int64 key -> (8T, S16) uint8 limb operand, K-major: row
    8t + l holds little-endian byte l of column t, and S is zero-padded to
    S16, a multiple of `TILE_S`."""
    S, T = ksk.shape
    # a transpose of whole words, then of the bytes within each word: on the
    # card, faster than transposing the (S, 8T) byte matrix in one copy
    words = ksk.t().contiguous().view(torch.uint8).reshape(T, S, 8)
    limbs = words.transpose(1, 2).contiguous().reshape(8 * T, S)
    pad = (-S) % TILE_S
    return F.pad(limbs, (0, pad)) if pad else limbs


def _require_operands(digits: torch.Tensor, limbs: torch.Tensor) -> None:
    """The operands' contract, on every device: int8 digits (the limb
    sums are exact only for them) and a limb operand of their S."""
    name = "keyswitch_mac"
    _build.require(name, digits.dtype == torch.int8 and limbs.dtype == torch.uint8,
                   f"needs int8 digits and a uint8 limb operand, got {digits.dtype} "
                   f"and {limbs.dtype}")
    _build.require(name, digits.dim() == 2 and limbs.dim() == 2 and limbs.shape[0] % 8 == 0
                   and limbs.shape[1] == digits.shape[1] + (-digits.shape[1]) % TILE_S,
                   f"shapes {tuple(digits.shape)} x {tuple(limbs.shape)}: the limb "
                   f"operand must be (8T, S rounded up to {TILE_S})")


def keyswitch_mac_plain(digits: torch.Tensor, limbs: torch.Tensor) -> torch.Tensor:
    """digits (B, S) int8, limbs (8T, S16) uint8 -> (B, T) int64 mod 2^64.

    Per stretch of S, the 8T limb products in float64 (exact: every
    partial sum is an integer below 2^31), cast to int32, then each t's
    8 limbs shifted by 8l and summed with wrapping int64 arithmetic."""
    _require_operands(digits, limbs)
    B, S = digits.shape
    T = limbs.shape[0] // 8
    scale = torch.tensor(_LIMB_SCALE, dtype=torch.int64, device=digits.device)
    out = torch.zeros((B, T), dtype=torch.int64, device=digits.device)
    for s0 in range(0, S, STRETCH):
        s1 = min(S, s0 + STRETCH)
        prod = torch.zeros((B, 8 * T), dtype=torch.float64, device=digits.device)
        for c0 in range(s0, s1, _PLAIN_CHUNK):
            c1 = min(s1, c0 + _PLAIN_CHUNK)
            prod += digits[:, c0:c1].to(torch.float64) @ limbs[:, c0:c1].to(torch.float64).t()
        limb_sums = prod.to(torch.int32).to(torch.int64).reshape(B, T, 8)
        out += (limb_sums * scale).sum(dim=-1)
    return out


def keyswitch_mac(digits: torch.Tensor, limbs: torch.Tensor) -> torch.Tensor:
    """digits (B, S) int8, limbs (8T, S16) uint8 from `ksk_limbs` ->
    (B, T) int64 mod 2^64."""
    if digits.device.type == "cpu":
        return keyswitch_mac_plain(digits, limbs)
    name = "keyswitch_mac"
    _build.require(name, digits.device.type == "cuda" and limbs.device == digits.device,
                   f"needs CUDA tensors on one device, got {digits.device} "
                   f"and {limbs.device}")
    _require_operands(digits, limbs)
    _build.require(name, digits.is_contiguous() and limbs.is_contiguous()
                   and digits.data_ptr() % 16 == 0 and limbs.data_ptr() % 16 == 0,
                   "needs contiguous, 16-byte aligned tensors")
    B, S = digits.shape
    S16, T = limbs.shape[1], limbs.shape[0] // 8
    if S16 != S:           # TMA rows must be a multiple of 16 bytes
        digits = F.pad(digits, (0, S16 - S))
    out = torch.zeros((B, T), dtype=torch.int64, device=digits.device)
    fn = _build.function("keyswitch", "keyswitch_mac_launch", 3, 3)
    _build.launch(name, fn, digits.data_ptr(), limbs.data_ptr(), out.data_ptr(),
                  B, S16, T, device=digits.device)
    return out


# --- int32 digits: the TPU kernel's contract on the int8 kernel ----------------

def split_int32(digits: torch.Tensor) -> torch.Tensor:
    """(B, S) int32 -> (5B, S) int8: row i*B + b holds balanced base-2^8
    digit i of digits[b], so digits = sum_i 2^(8i) d_i exactly."""
    d = digits.to(torch.int64)
    parts = []
    for _ in range(INT32_DIGITS):
        low = ((d + 128) & 255) - 128
        parts.append(low)
        d = (d - low) >> 8
    return torch.cat(parts, dim=0).to(torch.int8)


def fold_int32(out: torch.Tensor) -> torch.Tensor:
    """(5B, T) products of `split_int32`'s rows -> (B, T): sum_i
    2^(8i) out[i*B:(i+1)*B], wrapping mod 2^64."""
    B = out.shape[0] // INT32_DIGITS
    acc = out[:B].clone()
    for i in range(1, INT32_DIGITS):
        acc += out[i * B:(i + 1) * B] << (8 * i)
    return acc


def _require_int32(digits: torch.Tensor, ksk: torch.Tensor) -> None:
    _build.require("keyswitch_mac", digits.dtype == torch.int32 and ksk.dtype == torch.int64
                   and digits.dim() == 2 and ksk.dim() == 2
                   and digits.shape[1] == ksk.shape[0],
                   f"needs (B, S) int32 digits and an (S, T) int64 key, got "
                   f"{digits.dtype} {tuple(digits.shape)} x {ksk.dtype} {tuple(ksk.shape)}")


def keyswitch_mac_int32_plain(digits: torch.Tensor, ksk: torch.Tensor) -> torch.Tensor:
    """digits (B, S) int32, ksk (S, T) int64 -> (B, T) int64 mod 2^64: the
    plain version of `keyswitch_mac_int32`, exact."""
    _require_int32(digits, ksk)
    return fold_int32(keyswitch_mac_plain(split_int32(digits), ksk_limbs(ksk)))


def keyswitch_mac_int32(digits: torch.Tensor, ksk: torch.Tensor) -> torch.Tensor:
    """digits (B, S) int32 (any value), ksk (S, T) int64 (uint64 bits) ->
    (B, T) int64 mod 2^64, in one `keyswitch_mac` launch over 5B rows."""
    _require_int32(digits, ksk)
    if digits.device.type == "cpu":
        return keyswitch_mac_int32_plain(digits, ksk)
    return fold_int32(keyswitch_mac(split_int32(digits), ksk_limbs(ksk)))
