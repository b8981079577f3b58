"""Noise-budget analysis (the paper's Fig. 6 parameter interplay).

Variance propagation through the TFHE pipeline, Concrete-style:

    fresh LWE            var = lwe_std^2          (torus units^2)
    x + y                var_x + var_y
    c * x                c^2 * var
    key-switch           var + big_n * ks_level * E[digit^2] * lwe_std^2
                             + big_n * decomposition rounding term
    PBS output           n * (k+1) * pbs_level * N * B^2/12 * glwe_std^2
                             + n * (1 + k*N) / (4 * (2N)^2)   (mod-switch)

`failure_prob` is the Gaussian tail of the phase noise crossing half a
message slot (delta/2) — the paper keeps p_err < 2^-40.  These formulas
drive parameter validation tests and document WHY wider widths force the
larger (n, N) the paper's hardware must then cope with (Obs. in §III-B).
"""
from __future__ import annotations

import math

from repro_torch.core.params import TFHEParams


def fresh_var(p: TFHEParams) -> float:
    return p.glwe_std ** 2


def keyswitch_var(p: TFHEParams, var_in: float) -> float:
    B = 2.0 ** p.ks_base_log
    digit2 = B * B / 12.0
    key_term = p.big_n * p.ks_level * digit2 * (p.lwe_std ** 2)
    # rounding of dropped levels: uniform in +-2^(64 - l*blog - 1)
    drop = 2.0 ** -(p.ks_base_log * p.ks_level)
    round_term = p.big_n * (drop ** 2) / 48.0
    return var_in + key_term + round_term


def modswitch_var(p: TFHEParams, var_in: float) -> float:
    twoN = 2.0 * p.N
    return var_in + (1.0 + p.n * 0.5) / (12.0 * twoN * twoN)


def pbs_out_var(p: TFHEParams) -> float:
    """Output noise of blind rotation (independent of input noise)."""
    B = 2.0 ** p.pbs_base_log
    digit2 = B * B / 12.0
    ext = p.n * (p.k + 1) * p.pbs_level * p.N * digit2 * (p.glwe_std ** 2)
    drop = 2.0 ** -(p.pbs_base_log * p.pbs_level)
    round_term = p.n * (p.k + 1) * p.N * (drop ** 2) / 48.0
    return ext + round_term


def pre_rotation_std(p: TFHEParams, var_in: float) -> float:
    """Phase noise entering the blind rotation (after KS + MS)."""
    return math.sqrt(modswitch_var(p, keyswitch_var(p, var_in)))


def failure_prob(p: TFHEParams, var_in: float | None = None) -> float:
    """P[decode error]: phase noise exceeding half a message slot at the
    blind-rotation input (the step that actually rounds to a LUT slot)."""
    if var_in is None:
        var_in = pbs_out_var(p)       # steady state: output of previous PBS
    std = pre_rotation_std(p, var_in)
    half_slot = 2.0 ** -(p.width + p.padding_bits + 1)
    z = half_slot / max(std, 1e-300)
    # log-domain Gaussian tail: erfc(z/sqrt(2)) ~ exp(-z^2/2)
    return math.erfc(z / math.sqrt(2.0))


def log2_failure_prob(p: TFHEParams, width: int | None = None) -> float:
    w = p.width if width is None else width
    z = (2.0 ** -(w + p.padding_bits + 1)) / \
        max(pre_rotation_std(p, pbs_out_var(p)), 1e-300)
    # log2 erfc(z/sqrt2) ~ -z^2/(2 ln2) for large z
    return -(z * z) / (2.0 * math.log(2.0))


def radix_width(p: TFHEParams) -> int:
    """Per-PBS message width when a width-w program runs in radix
    (msg+carry) chunks — Concrete's strategy for small N (the paper's
    footnotes 3/4).  The LARGE-N sets (Table II's 32768/65536) carry the
    full width in one LUT up to 9 bits; at 10 bits the modulus-switch
    noise floor (~(n/2)/(12*(2N)^2)) forces the multi-LUT / bit-extraction
    evaluation of the paper's reference [10] (Chillotti et al., larger-
    precision PBS), i.e. radix chunks again."""
    if p.N >= 16384 and p.width <= 9:
        return p.width
    return (p.width + 1) // 2 + 1
