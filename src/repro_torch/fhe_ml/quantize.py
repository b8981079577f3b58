"""Post-training quantization for FHE execution.

The port's copy of `repro.fhe_ml.quantize`: numpy only, so every result
is the reference's bit for bit.

Two schemes live here:

*Affine* (Concrete-ML style, the narrow-LUT path): activations and
weights quantize to `width`-bit unsigned integers with per-tensor
scale/zero-point; matmul accumulators re-quantize through a LUT (the
"requant" PBS every FHE DNN layer ends with).  `width` is the PBS
plaintext window, so activations top out at a few bits.

*Radix* (the wide-activation path): activations quantize onto W-bit
two's-complement radix integers (`repro_torch.core.integer.RadixSpec`
digit vectors, W = 16/32), symmetric around zero so negation/relu keep
their two's-complement meaning.  Linear layers run EXACTLY in integers
(`radix_linear` nodes) — no requant LUT, no per-layer precision loss —
as long as every intermediate magnitude stays below 2^(W-1); the scale
is therefore chosen against the lowered block's accumulation headroom
(`calibrate_radix(..., qmax=...)`) and `check_radix_range` is the
compile-time certificate that the bound holds.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class QuantSpec:
    width: int
    scale: float
    zero: int

    @property
    def qmax(self) -> int:
        return (1 << self.width) - 1


def calibrate(x: np.ndarray, width: int) -> QuantSpec:
    lo, hi = float(np.min(x)), float(np.max(x))
    lo = min(lo, 0.0)
    hi = max(hi, lo + 1e-8)
    scale = (hi - lo) / ((1 << width) - 1)
    zero = int(round(-lo / scale))
    return QuantSpec(width, scale, zero)


def quantize_affine(x: np.ndarray, spec: QuantSpec) -> np.ndarray:
    q = np.round(x / spec.scale) + spec.zero
    return np.clip(q, 0, spec.qmax).astype(np.int64)


def dequantize(q: np.ndarray, spec: QuantSpec) -> np.ndarray:
    return (q.astype(np.float64) - spec.zero) * spec.scale


# ---------------------------------------------------------------------------
# radix quantization (16/32-bit encrypted activations)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class RadixQuantSpec:
    """Symmetric quantization onto W-bit two's-complement radix integers.

    float x maps to q = round(x / scale), a signed integer encrypted as
    a `bits`-wide little-endian digit vector of `msg_bits`-bit digits
    (`repro_torch.core.integer.RadixSpec` layout — msg_bits must divide
    bits and satisfy the parameter set's 2*msg_bits <= width carry
    budget).
    There is no zero-point: zero maps to zero, so `radix_relu`'s
    two's-complement sign test IS the float relu.

    scale is chosen by `calibrate_radix` against the headroom the
    lowered block needs (its `input_qmax`), not against the full
    2^(bits-1) range — integer linear algebra is exact only while no
    intermediate wraps past 2^(bits-1).  The calibrated cap is RECORDED
    on the spec (`qmax_cal`), and `quantize_to_radix` saturates at it:
    an out-of-calibration serving-time input clips to the certified
    range instead of silently voiding the overflow certificate.
    """
    bits: int
    msg_bits: int
    scale: float
    qmax_cal: int | None = None       # calibrated magnitude cap

    def __post_init__(self):
        assert self.bits % self.msg_bits == 0, (
            "integer width must be a whole number of digits")

    @property
    def n_digits(self) -> int:
        return self.bits // self.msg_bits

    @property
    def modulus(self) -> int:
        return 1 << self.bits

    @property
    def qmax(self) -> int:
        """Largest representable magnitude (two's-complement symmetric)."""
        return (1 << (self.bits - 1)) - 1

    @property
    def clip_max(self) -> int:
        """The quantization saturation point: the calibrated cap when
        one was recorded, else the full two's-complement range."""
        return self.qmax_cal if self.qmax_cal is not None else self.qmax


def calibrate_radix(x: np.ndarray, bits: int, msg_bits: int,
                    qmax: int | None = None) -> RadixQuantSpec:
    """Choose the radix scale for calibration data `x`.

    qmax caps the quantized magnitude; pass the lowered block's
    `input_qmax` (from `lower_mlp_radix` / `lower_gpt2_block_radix`
    meta) so the block's worst-case accumulators provably fit in
    2^(bits-1) — the radix analogue of the affine path's requant-LUT
    range discipline.  Defaults to the full two's-complement range.
    """
    amax = float(np.max(np.abs(x))) if np.size(x) else 0.0
    amax = max(amax, 1e-12)
    cap = int(qmax) if qmax is not None else (1 << (bits - 1)) - 1
    assert 1 <= cap < (1 << (bits - 1)), cap
    return RadixQuantSpec(bits, msg_bits, amax / cap, qmax_cal=cap)


def quantize_to_radix(x: np.ndarray, rq: RadixQuantSpec) -> np.ndarray:
    """float -> signed integers (int64), saturating at the CALIBRATED
    cap (`rq.clip_max`) so out-of-calibration inputs cannot exceed the
    magnitude the lowering's range certificate was proven for.  Values
    are SIGNED here; the client encrypts them mod 2^bits (two's
    complement) digit by digit."""
    cap = rq.clip_max
    q = np.round(np.asarray(x, np.float64) / rq.scale)
    return np.clip(q, -cap, cap).astype(np.int64)


def dequantize_radix(q: np.ndarray, rq: RadixQuantSpec) -> np.ndarray:
    """Decrypted residues mod 2^bits -> floats (two's-complement decode
    then * scale).  Accepts signed values too (they reduce mod 2^bits
    first, so both raw decrypts and oracle integers round-trip)."""
    q = np.asarray(q, np.int64) % rq.modulus
    signed = np.where(q >= rq.modulus // 2, q - rq.modulus, q)
    return signed.astype(np.float64) * rq.scale


def check_radix_range(bits: int, bound: float, what: str = "value") -> None:
    """The radix range certificate: raise OverflowError unless the
    worst-case magnitude `bound` fits two's-complement `bits`-bit
    integers.  Mod-2^bits digit arithmetic silently wraps past
    2^(bits-1) — relu would then flip sign and decrypted outputs would
    diverge from the float model, so lowerings call this on every
    intermediate interval bound before emitting a graph."""
    if bound >= float(1 << (bits - 1)):
        raise OverflowError(
            f"{what} bound {bound:g} overflows signed {bits}-bit radix "
            f"range (< {1 << (bits - 1)}): widen `bits` or narrow the "
            f"input quantization (lower `qmax` in calibrate_radix)")


def requant_table(in_scale: float, in_zero: float, out: QuantSpec,
                  in_width: int, fn=None) -> np.ndarray:
    """LUT mapping an accumulator value (in_width bits) to the next
    layer's quantized activation, optionally through `fn` (e.g. GELU)."""
    n = 1 << in_width
    xs = (np.arange(n, dtype=np.float64) - in_zero) * in_scale
    if fn is not None:
        xs = fn(xs)
    q = np.round(xs / out.scale) + out.zero
    return np.clip(q, 0, out.qmax).astype(np.uint64)
