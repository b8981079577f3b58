"""TFHE parameter sets (a field-for-field copy of `repro.core.params`;
the port keeps its own so it never imports the JAX package).

Terminology follows the paper (§II):
  n       LWE dimension of the *small* key (blind-rotation loop length)
  N       GLWE polynomial degree (power of two; paper scales to 2^16)
  k       GLWE dimension (paper: k=1 for wide multi-bit TFHE, Obs. 3)
  width   message bits per ciphertext (paper: up to 10)
  pbs_*   gadget decomposition of the external product (base 2^pbs_base_log,
          depth pbs_level)
  ks_*    gadget decomposition of key-switching
  *_std   noise standard deviations, in torus units (fraction of q)

The *big* LWE dimension (output of sample-extract, input of key-switch in
the paper's key-switching-first order) is always k*N.
"""
from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass(frozen=True)
class TFHEParams:
    name: str
    n: int
    N: int
    k: int
    width: int
    pbs_base_log: int
    pbs_level: int
    ks_base_log: int
    ks_level: int
    lwe_std: float
    glwe_std: float
    padding_bits: int = 1  # one carry/padding bit, Concrete-style

    @property
    def big_n(self) -> int:
        return self.k * self.N

    @property
    def q_bits(self) -> int:
        return 64

    @property
    def log2_N(self) -> int:
        return int(math.log2(self.N))

    @property
    def delta(self) -> int:
        """Scaling factor of the message encoding (one padding bit)."""
        return 1 << (self.q_bits - self.width - self.padding_bits)

    @property
    def plaintext_modulus(self) -> int:
        return 1 << self.width

    def validate(self) -> None:
        assert self.N & (self.N - 1) == 0, "N must be a power of two"
        assert self.pbs_base_log * self.pbs_level <= self.q_bits
        assert self.ks_base_log * self.ks_level <= self.q_bits
        assert self.width + self.padding_bits <= self.log2_N, (
            "LUT needs >=1 coefficient per message slot"
        )


# --- Unit-test parameter sets -----------------------------------------------
# Correctness-oriented: small n/N keep CPU tests fast; noise is set low so
# the decryption-failure probability is negligible. NOT cryptographically
# secure (security needs n ~ 700+, see PAPER_PARAMS); correctness and
# dataflow are identical.
TEST_PARAMS = TFHEParams(
    name="test-2bit",
    n=64, N=512, k=1, width=2,
    pbs_base_log=12, pbs_level=2,
    ks_base_log=4, ks_level=5,
    lwe_std=2.0 ** -45, glwe_std=2.0 ** -45,
)

TEST_PARAMS_4BIT = TFHEParams(
    name="test-4bit",
    n=96, N=2048, k=1, width=4,
    pbs_base_log=14, pbs_level=2,
    ks_base_log=5, ks_level=5,
    lwe_std=2.0 ** -48, glwe_std=2.0 ** -48,
)

TEST_PARAMS_6BIT = TFHEParams(
    name="test-6bit",
    n=128, N=4096, k=1, width=6,
    pbs_base_log=16, pbs_level=2,
    ks_base_log=6, ks_level=4,
    lwe_std=2.0 ** -50, glwe_std=2.0 ** -50,
)

TEST_PARAMS_K2 = TFHEParams(
    name="test-2bit-k2",
    n=48, N=256, k=2, width=2,
    pbs_base_log=12, pbs_level=2,
    ks_base_log=4, ks_level=5,
    lwe_std=2.0 ** -45, glwe_std=2.0 ** -45,
)

# --- Paper parameter sets (Table II) -----------------------------------------
# n, (N, k), width exactly as reported; decomposition/noise follow the
# Concrete optimizer's choices for 128-bit security at p_err < 2^-40.
# These drive the cost model and dry-run style benchmarks (a full blind
# rotation at N=65536 is run through the batched engine, not unit tests).
def _paper(name, n, N, k, width):
    # Representative Concrete-style decomposition for 64-bit torus at these
    # scales (base/level grow with width; values match TFHE-rs defaults for
    # the corresponding precision tier).
    if width <= 4:
        pbs = (23, 1); ks = (3, 5)
    elif width <= 6:
        pbs = (22, 1); ks = (3, 6)
    elif width <= 8:
        pbs = (15, 2); ks = (4, 6)
    else:
        pbs = (11, 3); ks = (4, 7)
    return TFHEParams(
        name=name, n=n, N=N, k=k, width=width,
        pbs_base_log=pbs[0], pbs_level=pbs[1],
        ks_base_log=ks[0], ks_level=ks[1],
        # Fig. 6 security line (128-bit): log2(sigma) ~ -0.0255 * n
        lwe_std=2.0 ** (-0.0255 * n), glwe_std=2.0 ** -51,
    )


PAPER_PARAMS = {
    # Table II: workload -> n, (N, k), width
    "cnn20":       _paper("cnn20",       737,  2048,  1, 6),
    "cnn50":       _paper("cnn50",       828,  4096,  1, 6),
    "decision_tree": _paper("decision_tree", 1070, 65536, 1, 9),
    "gpt2":        _paper("gpt2",        1003, 32768, 1, 6),
    "gpt2_12head": _paper("gpt2_12head", 1009, 32768, 1, 6),
    "knn":         _paper("knn",         1058, 65536, 1, 9),
    "xgboost":     _paper("xgboost",     1025, 32768, 1, 8),
    # the paper's 10-bit headline capability
    "max10bit":    _paper("max10bit",    1100, 65536, 1, 10),
}

for _p in list(PAPER_PARAMS.values()) + [TEST_PARAMS, TEST_PARAMS_4BIT, TEST_PARAMS_K2]:
    _p.validate()
