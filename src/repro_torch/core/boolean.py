"""Boolean TFHE — the paper's comparison BASELINE (Fig. 2a / Fig. 5 top).

The port of `repro.core.boolean`.  Bits are encoded as ±1/8 on the
torus; every gate is one linear combination followed by a
sign-extracting programmable bootstrap (the "gate bootstrapping" that
makes Boolean TFHE ~1000x slower per useful operation than multi-bit
linear ops — Observation 1).

Gates (lin -> sign PBS), with T = 2^64:
    AND : a + b - 1/8        OR  : a + b + 1/8
    NAND: 1/8 - a - b        XOR : 2a + 2b + 1/4
    NOT : -a  (no bootstrap)
Full adder: s = a^b^cin (2 XOR-PBS), cout = MAJ(a,b,cin) = sign(a+b+cin)
(1 PBS) => 3 bootstraps per bit vs the paper's 5-gate count.

The sign bootstrap is `TaurusEngine.lut_batch` with the constant +1/8
test polynomial (the reference runs the same KS-first pipeline through
its plain batch functions), so on the card the gates run the engine's
kernels.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.core import lwe
from repro_torch.core.engine import TaurusEngine
from repro_torch.core.params import TFHEParams
from repro_torch.core.pbs import TFHEContext

I64 = torch.int64
EIGHTH = 1 << 61       # 1/8 of the torus
QUARTER = 1 << 62


def encode_bit(b) -> torch.Tensor:
    """bit -> ±1/8 torus."""
    b = torch.as_tensor(b, dtype=I64)
    return torch.where(b > 0, EIGHTH, -EIGHTH)


@dataclasses.dataclass
class BooleanContext:
    """Gate-bootstrapping layer over a TFHEContext's key material."""
    ctx: TFHEContext
    # None = a fused-backend engine on the keys' device, built on first use
    engine: Optional[TaurusEngine] = None

    @property
    def params(self) -> TFHEParams:
        return self.ctx.params

    # -- client ----------------------------------------------------------
    def encrypt(self, generator: torch.Generator, bits) -> torch.Tensor:
        m = encode_bit(bits).to(self.ctx.device)
        return lwe.encrypt(generator, self.ctx.big_sk, m, self.params.glwe_std)

    def decrypt(self, ct: torch.Tensor) -> torch.Tensor:
        ph = lwe.decrypt_phase(self.ctx.big_sk, ct)
        # the unsigned phase is below 2^63 exactly when the int64 is >= 0
        return (ph >= 0).to(torch.int32)

    # -- the sign bootstrap ------------------------------------------------
    def _sign_pbs(self, cts: torch.Tensor) -> torch.Tensor:
        """(B, big_n+1) -> sign-refreshed ±1/8 ciphertexts (one PBS each)."""
        if self.engine is None:
            self.engine = TaurusEngine.from_context(self.ctx, device=self.ctx.device)
        p = self.params
        polys = torch.full((cts.shape[0], p.N), EIGHTH, dtype=I64,
                           device=self.engine.device)
        return self.engine.lut_batch(cts, polys)

    # -- gates (batched over leading axis) ----------------------------------
    def _const(self, c: int, like: torch.Tensor) -> torch.Tensor:
        z = torch.zeros_like(like)
        z[..., -1] = c
        return z

    def nand(self, a, b):
        lin = self._const(EIGHTH, a) - a - b
        return self._sign_pbs(lin)

    def and_(self, a, b):
        lin = a + b - self._const(EIGHTH, a)
        return self._sign_pbs(lin)

    def or_(self, a, b):
        lin = a + b + self._const(EIGHTH, a)
        return self._sign_pbs(lin)

    def xor(self, a, b):
        lin = (a + b) * 2 + self._const(QUARTER, a)
        return self._sign_pbs(lin)

    def maj(self, a, b, c):
        """Majority(a, b, c) — the carry of a full adder in ONE PBS."""
        return self._sign_pbs(a + b + c)

    def not_(self, a):
        return -a

    # -- ripple-carry adder (Fig. 5 top) -------------------------------------
    def add_ripple(self, a_bits: torch.Tensor, b_bits: torch.Tensor):
        """Add two little-endian encrypted bit vectors (n, big_n+1).

        Returns (n+1, big_n+1) sum bits.  3 bootstraps per bit position
        (2 XOR + 1 MAJ)."""
        n = a_bits.shape[0]
        carry = None
        out = []
        for i in range(n):
            axb = self.xor(a_bits[i:i + 1], b_bits[i:i + 1])
            if carry is None:
                out.append(axb)
                carry = self.and_(a_bits[i:i + 1], b_bits[i:i + 1])
            else:
                out.append(self.xor(axb, carry))
                carry = self.maj(a_bits[i:i + 1], b_bits[i:i + 1], carry)
        out.append(carry)
        return torch.cat(out, dim=0)

    @property
    def bootstraps_per_add_bit(self) -> int:
        return 3
