"""Radix wide-integer arithmetic on the batched engine (the paper's
"multi-bit TFHE unlocks integer workloads" claim, §I Obs. 1-2).

The port of `repro.core.integer`: same digit layout, same tables (numpy,
built once per width), same carry strategies and the same rounds, so
`stats` match the reference's round for round.

A W-bit integer is a little-endian vector of D = W / msg_bits DIGITS;
each digit is an ordinary multi-bit LWE ciphertext whose 2^width
plaintext space is split into `msg_bits` of message and
`width - msg_bits` of carry headroom (the Concrete/TFHE-rs radix
representation).  Linear digit work (adds, negation, plaintext shifts)
is LPU-only and wraps mod 2^64 in int64; every nonlinear step — carry
extraction, partial products, comparisons, sign masking — is ONE batched
PBS dispatched through `TaurusEngine.lut_batch`, so a carry-propagation
round over all D digits streams the BSK once for the whole digit vector
instead of D times (round-robin key reuse, paper §III-B / Fig. 13).

Carry propagation strategies:
  ripple     D rounds of batched (msg, carry) extraction; works for any
             width >= 2.
  prefix     Hillis-Steele scan over generate/propagate statuses:
             2 + ceil(log2(D)) batched rounds; needs width >= 4 because
             the status combine is a bivariate LUT over two 2-bit
             statuses.
  lookahead  two-level carry-lookahead for narrow windows (width < 4):
             the status is kept as TWO single-bit ciphertexts (generate,
             propagate) and each Hillis-Steele level splits into two
             batched rounds of univariate LUTs over bit SUMS, so the
             base-2 path drops its D-round ripple for
             2*ceil(log2(D)) + 2 rounds.
All run every round as a single `lut_batch` call of >= D ciphertexts.
"""
from __future__ import annotations

import dataclasses
import functools
import threading

import numpy as np
import torch

from repro_torch.core import glwe, lwe, torus
from repro_torch.core.engine import TaurusEngine
from repro_torch.core.params import TFHEParams
from repro_torch.core.pbs import TFHEContext


# ---------------------------------------------------------------------------
# digit layout
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class RadixSpec:
    """Digit layout of a W-bit integer under one TFHEParams message space."""
    params: TFHEParams
    bits: int                 # integer width W (8 / 16 / 32 ...)
    msg_bits: int             # message bits per digit

    @classmethod
    def create(cls, params: TFHEParams, bits: int,
               msg_bits: int | None = None) -> "RadixSpec":
        m = msg_bits if msg_bits is not None else max(1, params.width // 2)
        spec = cls(params, bits, m)
        spec.validate()
        return spec

    def validate(self) -> None:
        assert self.msg_bits >= 1
        # carry space must cover at least the message space: a digit can
        # then absorb base-1 worth of carries, and bivariate LUTs
        # (a*base + b) fit the plaintext window.
        assert 2 * self.msg_bits <= self.params.width, (
            f"need width >= 2*msg_bits for carries+bivariate LUTs "
            f"(width={self.params.width}, msg_bits={self.msg_bits})")
        assert self.bits % self.msg_bits == 0, (
            "integer width must be a whole number of digits")

    @property
    def base(self) -> int:
        return 1 << self.msg_bits

    @property
    def n_digits(self) -> int:
        return self.bits // self.msg_bits

    @property
    def modulus(self) -> int:
        return 1 << self.bits

    # -- plaintext encode/decode -------------------------------------------
    def to_digits(self, value: int) -> np.ndarray:
        v = int(value) % self.modulus
        return np.array(
            [(v >> (i * self.msg_bits)) & (self.base - 1)
             for i in range(self.n_digits)], dtype=np.uint64)

    def from_digits(self, digits) -> int:
        """Weighted recombination mod 2^bits.  Tolerates un-propagated
        carries (digit values >= base) — the weighted sum still lands on
        the represented integer."""
        v = 0
        for i, d in enumerate(np.asarray(digits, dtype=np.uint64).tolist()):
            v += int(d) << (i * self.msg_bits)
        return v % self.modulus


@dataclasses.dataclass
class RadixCiphertext:
    """Encrypted wide integer: (D, k*N+1) int64 big-key LWE digit
    ciphertexts, little-endian along axis 0."""
    spec: RadixSpec
    digits: torch.Tensor


# ---------------------------------------------------------------------------
# LUT tables (all indexed by the full 2^width plaintext window)
# ---------------------------------------------------------------------------

def _tbl(width: int, fn) -> np.ndarray:
    n = 1 << width
    return np.array([fn(v) % n for v in range(n)], dtype=np.uint64)


@functools.lru_cache(maxsize=None)
def msg_table(width: int, msg_bits: int) -> np.ndarray:
    return _tbl(width, lambda v: v & ((1 << msg_bits) - 1))


@functools.lru_cache(maxsize=None)
def carry_table(width: int, msg_bits: int) -> np.ndarray:
    return _tbl(width, lambda v: v >> msg_bits)


@functools.lru_cache(maxsize=None)
def sigma_table(width: int, msg_bits: int) -> np.ndarray:
    """Carry status of a digit sum s <= 2*base-1:
    2 = generate (s >= base), 1 = propagate (s == base-1), 0 = neither."""
    base = 1 << msg_bits
    return _tbl(width, lambda s: 2 if s >= base else (1 if s == base - 1 else 0))


@functools.lru_cache(maxsize=None)
def combine_table(width: int, to_carry: bool) -> np.ndarray:
    """Status monoid hi o lo (hi = more significant): hi unless hi is
    propagate, then lo.  Input is the radix-4 pack hi*4 + lo.  With
    to_carry the resolved status is mapped straight to the carry bit
    (generate -> 1), folding the carry readout into the final scan round."""
    def f(c):
        hi, lo = (c >> 2) & 3, c & 3
        r = hi if hi != 1 else lo
        return (1 if r == 2 else 0) if to_carry else r
    return _tbl(width, f)


@functools.lru_cache(maxsize=None)
def status_carry_table(width: int) -> np.ndarray:
    """sigma -> carry bit, for scan lanes whose prefix is already final."""
    return _tbl(width, lambda s: 1 if (s & 3) == 2 else 0)


@functools.lru_cache(maxsize=None)
def status_id_table(width: int) -> np.ndarray:
    """sigma -> sigma: lanes below the scan distance ride along in the
    round's batch (keeps every carry round at >= D ciphertexts)."""
    return _tbl(width, lambda s: s & 3)


@functools.lru_cache(maxsize=None)
def generate_table(width: int, msg_bits: int) -> np.ndarray:
    """Digit sum s -> generate bit [s >= base] (lookahead status)."""
    base = 1 << msg_bits
    return _tbl(width, lambda s: 1 if s >= base else 0)


@functools.lru_cache(maxsize=None)
def propagate_bit_table(width: int, msg_bits: int) -> np.ndarray:
    """Digit sum s -> propagate bit [s == base - 1] (lookahead status)."""
    base = 1 << msg_bits
    return _tbl(width, lambda s: 1 if s == base - 1 else 0)


@functools.lru_cache(maxsize=None)
def bit_and_table(width: int) -> np.ndarray:
    """Sum of two bits -> their AND ([x + y >= 2]); the bivariate bit op
    as a univariate LUT over an LPU add (fits any width >= 2 window)."""
    return _tbl(width, lambda v: 1 if v >= 2 else 0)


@functools.lru_cache(maxsize=None)
def bit_or_table(width: int) -> np.ndarray:
    """Sum of two bits -> their OR ([x + y >= 1]).  On a single bit this
    is the identity, so it doubles as the noise-refresh pass-through for
    scan lanes whose prefix is already final."""
    return _tbl(width, lambda v: 1 if v >= 1 else 0)


@functools.lru_cache(maxsize=None)
def pp_table(width: int, msg_bits: int, hi: bool) -> np.ndarray:
    """Partial product of two digits packed as a*base + b."""
    base = 1 << msg_bits
    def f(c):
        a, b = c >> msg_bits, c & (base - 1)
        p = a * b
        return p >> msg_bits if hi else p & (base - 1)
    return _tbl(width, f)


@functools.lru_cache(maxsize=None)
def cmp_digit_table(width: int, msg_bits: int) -> np.ndarray:
    """Digit comparison a*base + b -> {0: a==b, 1: a<b, 2: a>b}."""
    base = 1 << msg_bits
    def f(c):
        a, b = c >> msg_bits, c & (base - 1)
        return 0 if a == b else (1 if a < b else 2)
    return _tbl(width, f)


@functools.lru_cache(maxsize=None)
def cmp_combine_table(width: int) -> np.ndarray:
    """Lexicographic verdict hi*4 + lo -> hi unless digits tied."""
    def f(c):
        hi, lo = (c >> 2) & 3, c & 3
        return hi if hi != 0 else lo
    return _tbl(width, f)


@functools.lru_cache(maxsize=None)
def sign_table(width: int, msg_bits: int) -> np.ndarray:
    """Top digit -> two's-complement sign bit (its own MSB)."""
    base = 1 << msg_bits
    return _tbl(width, lambda d: 1 if (d & (base - 1)) >= base // 2 else 0)


@functools.lru_cache(maxsize=None)
def mask_table(width: int, msg_bits: int) -> np.ndarray:
    """sign*base + digit -> digit if sign == 0 else 0 (ReLU masking)."""
    base = 1 << msg_bits
    return _tbl(width, lambda c: 0 if c >= base else c)


def _pad_batch(b: int) -> int:
    """Quantized PBS batch sizes: a floor of 16, then 32, then multiples
    of 32.  The reference pads so its jitted pbs_batch compiles for few
    shapes; the port has no jit but pads the same way, so the rounds it
    dispatches (`stats["dispatch_sizes"]`) are the reference's and its
    kernels see the same few row counts.  Under the fused serving
    scheduler a request's rounds go unpadded and the scheduler pads the
    fused batch (`IntegerContext.pad_batches`)."""
    if b <= 32:
        return 1 << max(4, (b - 1).bit_length())
    return -(-b // 32) * 32


def _add_shifted(lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """lo with hi[:-1] added onto lo[1:]: a digit vector plus the carries
    (or high halves) of the digit below (the reference's
    `lo.at[1:].add(hi[:-1])`)."""
    out = lo.clone()
    out[1:] += hi[:-1]
    return out


# ---------------------------------------------------------------------------
# client + server API
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class IntegerContext:
    """Encrypt/compute/decrypt wide integers over a TFHEContext's keys,
    dispatching every nonlinear round through `TaurusEngine.lut_batch`."""
    ctx: TFHEContext
    engine: TaurusEngine
    # pad each round to `_pad_batch` rows; off under the fused scheduler,
    # which pads the fused batch instead
    pad_batches: bool = True
    # optional telemetry (duck-typed counter); every nonlinear round
    # adds its logical rows to integer.pbs when set
    telemetry: object = None
    stats: dict = dataclasses.field(default_factory=lambda: {
        "pbs": 0, "lut_batches": 0, "batch_sizes": [], "dispatch_sizes": []})
    _poly_cache: dict = dataclasses.field(default_factory=dict, repr=False)
    # stats counters are read-modify-write; the serving fan-out runs
    # several vector threads through ONE context, so guard them
    _stats_lock: object = dataclasses.field(
        default_factory=threading.Lock, repr=False)

    @classmethod
    def create(cls, ctx: TFHEContext, engine: TaurusEngine | None = None,
               **kw) -> "IntegerContext":
        """`engine` defaults to a fused-backend engine on the keys' device."""
        return cls(ctx, engine or TaurusEngine.from_context(ctx, device=ctx.device),
                   **kw)

    @property
    def params(self) -> TFHEParams:
        return self.ctx.params

    def spec(self, bits: int, msg_bits: int | None = None) -> RadixSpec:
        return RadixSpec.create(self.params, bits, msg_bits)

    def reset_stats(self) -> None:
        with self._stats_lock:
            self.stats.update(pbs=0, lut_batches=0, batch_sizes=[],
                              dispatch_sizes=[])

    # -- client side --------------------------------------------------------
    def encrypt(self, generator: torch.Generator, value: int, bits: int,
                msg_bits: int | None = None) -> RadixCiphertext:
        """All D digits in one draw from `generator` (the reference splits
        a key per digit; `torch.Generator` streams are drawn in order)."""
        spec = self.spec(bits, msg_bits)
        digs = torch.as_tensor(spec.to_digits(value).astype(np.int64),
                               device=self.ctx.device)
        return RadixCiphertext(spec, self.ctx.encrypt(generator, digs))

    def decrypt_digits(self, rct: RadixCiphertext) -> np.ndarray:
        return self.ctx.decrypt(rct.digits).cpu().numpy().astype(np.uint64)

    def decrypt(self, rct: RadixCiphertext) -> int:
        return rct.spec.from_digits(self.decrypt_digits(rct))

    def digit_noise(self, rct: RadixCiphertext, value: int) -> np.ndarray:
        """Signed per-digit residual noise (torus units) against the digits
        of the expected plaintext `value` — valid on carry-propagated
        ciphertexts, whose digits are all below base."""
        expect = torch.as_tensor(rct.spec.to_digits(value).astype(np.int64),
                                 device=rct.digits.device)
        return self.ctx.decrypt_noise(rct.digits, expect).cpu().numpy()

    # -- the one nonlinear primitive ----------------------------------------
    def _lut(self, cts: torch.Tensor, tables: np.ndarray) -> torch.Tensor:
        """One PBS batch: per-ciphertext integer tables -> refreshed cts.

        With `pad_batches`, pads the batch to a quantized size (repeating
        real ciphertexts), as the reference does, so the dispatched rounds
        match its."""
        b = int(cts.shape[0])
        tables = np.ascontiguousarray(np.asarray(tables, dtype=np.uint64))
        dispatch = cts
        dtables = tables
        if self.pad_batches:
            p = _pad_batch(b)
            if p > b:
                reps = -(-p // b)
                dispatch = cts.repeat(reps, 1)[:p]
                dtables = np.tile(tables, (reps, 1))[:p]
        out = self.engine.lut_batch(dispatch, self._polys(dtables))
        with self._stats_lock:
            self.stats["lut_batches"] += 1
            self.stats["pbs"] += b
            self.stats["batch_sizes"].append(b)
            self.stats["dispatch_sizes"].append(int(dispatch.shape[0]))
        if self.telemetry is not None:
            self.telemetry.counter("integer.pbs").inc(b)
        return out[:b]

    def _polys(self, tables: np.ndarray) -> torch.Tensor:
        # stack-level cache on top of the process-wide per-row cache:
        # repeated rounds reuse the same few stacks, and concurrent
        # serving contexts share the row encodes.  Stacks live on the
        # engine's device, so a repeated round uploads nothing.
        key = tables.tobytes()
        stack = self._poly_cache.get(key)
        if stack is None:
            stack = self._poly_cache[key] = glwe.make_lut_polys_cached(
                tables, self.params, device=getattr(self.engine, "device", None))
        return stack

    def _trivial_digits(self, spec: RadixSpec, value: int) -> torch.Tensor:
        m = torus.encode(torch.full((spec.n_digits,), torus.as_i64(value),
                                    dtype=torch.int64),
                         self.params.delta, device=self.ctx.device)
        return lwe.trivial(m, self.params.big_n)

    # -- carry propagation ---------------------------------------------------
    def _extract_round(self, digits: torch.Tensor, spec: RadixSpec) -> torch.Tensor:
        """One batched (msg, carry) extraction + shifted re-add: the ripple
        round.  Batch size 2D, one key-stream for the whole vector."""
        d = spec.n_digits
        w, m = self.params.width, spec.msg_bits
        batch = torch.cat([digits, digits], dim=0)
        tables = np.concatenate([np.tile(msg_table(w, m), (d, 1)),
                                 np.tile(carry_table(w, m), (d, 1))])
        out = self._lut(batch, tables)
        return _add_shifted(out[:d], out[d:])

    def _propagate_ripple(self, digits: torch.Tensor, spec: RadixSpec,
                          rounds: int) -> torch.Tensor:
        for _ in range(rounds):
            digits = self._extract_round(digits, spec)
        return digits

    def _propagate_prefix(self, digits: torch.Tensor, spec: RadixSpec) -> torch.Tensor:
        """Hillis-Steele carry scan.  Preconditions: width >= 4, every
        digit value <= 2*base - 1 and already including its incoming
        additions (no external carry-in)."""
        d = spec.n_digits
        w, m = self.params.width, spec.msg_bits
        # round 1: messages + generate/propagate statuses, one 2D batch
        batch = torch.cat([digits, digits], dim=0)
        tables = np.concatenate([np.tile(msg_table(w, m), (d, 1)),
                                 np.tile(sigma_table(w, m), (d, 1))])
        out = self._lut(batch, tables)
        msg, sig = out[:d], out[d:]
        # scan rounds: log2(D) bivariate status combines.  Every round
        # dispatches all D lanes — lanes below the scan distance pass
        # through a univariate status table — and the last round's LUTs
        # map the resolved status straight to the carry bit.
        dists = []
        dd = 1
        while dd < d:
            dists.append(dd)
            dd *= 2
        carries = None
        for i, dd in enumerate(dists):
            last = i == len(dists) - 1
            comb = lwe.add(lwe.scalar_mul(sig[dd:], 4), sig[:-dd])
            batch = torch.cat([sig[:dd], comb], dim=0)
            lo_tbl = status_carry_table(w) if last else status_id_table(w)
            tables = np.concatenate(
                [np.tile(lo_tbl, (dd, 1)),
                 np.tile(combine_table(w, to_carry=last), (d - dd, 1))])
            out = self._lut(batch, tables)
            if last:
                carries = out
            else:
                sig = out
        # final: add carries and fold digit sums (<= base) back below base.
        # msg_table is the identity below base, so digit 0 rides along and
        # the round stays a full-width D batch.
        summed = _add_shifted(msg, carries)
        return self._lut(summed, np.tile(msg_table(w, m), (d, 1)))

    def _propagate_lookahead(self, digits: torch.Tensor, spec: RadixSpec) -> torch.Tensor:
        """Two-level carry-lookahead for narrow plaintext windows.

        The packed Hillis-Steele scan (`_propagate_prefix`) needs a 4-bit
        window for its radix-4 status pairs.  Below that, the
        (generate, propagate) status lives in TWO single-bit ciphertexts
        and each scan level becomes two batched rounds — the monoid
        combine (g, p) o (g', p') = (g | (p & g'), p & p') decomposed
        into its two levels of bit logic, each an AND/OR evaluated as a
        univariate LUT over an LPU bit sum:

          round A:  t_i  = p_i AND g_{i-dd}     ([p + g >= 2])
                    p_i <- p_i AND p_{i-dd}
          round B:  g_i <- g_i OR t_i           ([g + t >= 1])

        1 + 2*ceil(log2(D)) + 1 batched rounds total, vs D ripple
        rounds.  Preconditions: D > 1 and every digit value
        <= 2*base - 2 (same as the prefix scan)."""
        d = spec.n_digits
        w, m = self.params.width, spec.msg_bits
        # round 1: messages + both status bits, one 3D batch
        batch = torch.cat([digits, digits, digits], dim=0)
        tables = np.concatenate([np.tile(msg_table(w, m), (d, 1)),
                                 np.tile(generate_table(w, m), (d, 1)),
                                 np.tile(propagate_bit_table(w, m), (d, 1))])
        out = self._lut(batch, tables)
        msg, g, p = out[:d], out[d:2 * d], out[2 * d:]
        dd = 1
        while dd < d:
            k = d - dd
            # round A: lookahead terms + propagate combine for lanes >= dd;
            # lanes below the scan distance refresh p through the bit
            # identity (OR) so the round stays >= D ciphertexts
            batch = torch.cat([lwe.add(p[dd:], g[:-dd]),
                               lwe.add(p[dd:], p[:-dd]),
                               p[:dd]], dim=0)
            tables = np.concatenate([np.tile(bit_and_table(w), (2 * k, 1)),
                                     np.tile(bit_or_table(w), (dd, 1))])
            out = self._lut(batch, tables)
            t = out[:k]
            p = torch.cat([out[2 * k:], out[k:2 * k]], dim=0)
            # round B: fold the lookahead term into g (lanes < dd final)
            batch = torch.cat([g[:dd], lwe.add(g[dd:], t)], dim=0)
            g = self._lut(batch, np.tile(bit_or_table(w), (d, 1)))
            dd *= 2
        # g[i] is now the carry OUT of digit i; stitch and fold below base
        summed = _add_shifted(msg, g)
        return self._lut(summed, np.tile(msg_table(w, m), (d, 1)))

    @staticmethod
    def lookahead_rounds(n_digits: int) -> int:
        """Batched-PBS rounds of the two-level lookahead strategy."""
        return 2 + 2 * max(0, (n_digits - 1).bit_length())

    def propagate(self, rct: RadixCiphertext, max_val: int | None = None,
                  strategy: str = "auto") -> RadixCiphertext:
        """Carry-propagate so every digit lands in [0, base).

        max_val bounds the current per-digit plaintext value (defaults to
        the whole 2^width window); values above 2*base-2 are first folded
        down by batched extraction rounds.  The 2*base-2 ceiling keeps
        every intermediate carry in {0, 1} — the prefix statuses cannot
        express a carry of 2 (which v = 2*base-1 plus an incoming carry
        would produce)."""
        spec = rct.spec
        base, w = spec.base, self.params.width
        digits = rct.digits
        if max_val is None:
            max_val = (1 << w) - 1
        # pre-reduction: each round maps v -> (v mod base) + (v' >> msg)
        while max_val > 2 * base - 2:
            max_val = (base - 1) + (max_val >> spec.msg_bits)
            digits = self._extract_round(digits, spec)
        if strategy == "auto":
            if w >= 4 and spec.n_digits > 1:
                strategy = "prefix"
            elif (spec.n_digits > 1
                  and self.lookahead_rounds(spec.n_digits) < spec.n_digits):
                strategy = "lookahead"       # narrow window, long chains
            else:
                strategy = "ripple"
        if strategy == "prefix":
            # the radix-4 status pack needs a 4-bit window, and a single
            # digit has no carries to scan — explicit misuse would decrypt
            # wrong, not just slow
            assert w >= 4 and spec.n_digits > 1, (
                "prefix carry scan needs width >= 4 and more than one digit")
            digits = self._propagate_prefix(digits, spec)
        elif strategy == "lookahead":
            assert spec.n_digits > 1, (
                "lookahead carry scan needs more than one digit")
            digits = self._propagate_lookahead(digits, spec)
        else:
            digits = self._propagate_ripple(digits, spec, spec.n_digits)
        return RadixCiphertext(spec, digits)

    # -- arithmetic -----------------------------------------------------------
    def add(self, a: RadixCiphertext, b: RadixCiphertext) -> RadixCiphertext:
        assert a.spec == b.spec
        s = lwe.add(a.digits, b.digits)
        return self.propagate(RadixCiphertext(a.spec, s),
                              max_val=2 * a.spec.base - 2)

    def sub(self, a: RadixCiphertext, b: RadixCiphertext) -> RadixCiphertext:
        """a - b mod 2^bits, via base-complement: a + ~b + 1."""
        assert a.spec == b.spec
        spec = a.spec
        neg = lwe.sub(self._trivial_digits(spec, spec.base - 1), b.digits)
        s = lwe.add(a.digits, neg)
        s[0, -1] += torus.as_i64(self.params.delta)        # the +1 at the LSB
        # max_val describes digits that can RECEIVE a carry (<= 2*base-2);
        # only digit 0 holds the extra +1, and it has no incoming carry,
        # so its 2*base-1 ceiling still yields a single outgoing carry.
        return self.propagate(RadixCiphertext(spec, s),
                              max_val=2 * spec.base - 2)

    def _pp_batch(self, comb: torch.Tensor, spec: RadixSpec):
        """Dispatch packed digit pairs (a*base + b) through BOTH partial-
        product halves in one batch; returns (lo, hi) digit vectors."""
        t = int(comb.shape[0])
        w, m = self.params.width, spec.msg_bits
        batch = torch.cat([comb, comb], dim=0)
        tables = np.concatenate([np.tile(pp_table(w, m, hi=False), (t, 1)),
                                 np.tile(pp_table(w, m, hi=True), (t, 1))])
        out = self._lut(batch, tables)
        return out[:t], out[t:]

    def mul_digit(self, a: RadixCiphertext, digit_ct: torch.Tensor) -> RadixCiphertext:
        """Multiply by ONE encrypted digit (< base): a row of the schoolbook
        product.  Both partial-product halves run as a single 2D batch."""
        spec = a.spec
        base = spec.base
        comb = lwe.add(lwe.scalar_mul(a.digits, base),
                       digit_ct.expand_as(a.digits))
        lo, hi = self._pp_batch(comb, spec)
        return self.propagate(RadixCiphertext(spec, _add_shifted(lo, hi)),
                              max_val=2 * base - 3)

    def mul(self, a: RadixCiphertext, b: RadixCiphertext) -> RadixCiphertext:
        """Schoolbook product mod 2^bits.  All D*(D+1) partial-product LUTs
        fire as ONE batch; column sums then compress through batched
        carry-save rounds sized to the carry headroom."""
        assert a.spec == b.spec
        spec = a.spec
        d, base = spec.n_digits, spec.base
        w, m = self.params.width, spec.msg_bits
        window = (1 << w) - 1

        pairs = [(i, j) for i in range(d) for j in range(d - i)]
        ii = torch.tensor([i for i, _ in pairs], device=a.digits.device)
        jj = torch.tensor([j for _, j in pairs], device=b.digits.device)
        comb = lwe.add(lwe.scalar_mul(a.digits[ii], base), b.digits[jj])
        lo, hi = self._pp_batch(comb, spec)

        # columns of (ciphertext, max plaintext value) terms
        cols: list = [[] for _ in range(d)]
        for k, (i, j) in enumerate(pairs):
            cols[i + j].append((lo[k], base - 1))
            if i + j + 1 < d:
                cols[i + j + 1].append((hi[k], max(base - 2, 0)))
        # carry-save compression: per round, greedily group terms whose
        # plaintext sum fits the 2^width window, then extract (msg, carry)
        # for every group in one batch.
        guard = 0
        while any(len(c) > 1 for c in cols):
            guard += 1
            assert guard <= 8 * d, "carry-save reduction failed to converge"
            groups = []          # (col, [cts], group_max)
            for ci in range(d):
                col = cols[ci]
                if len(col) < 2:
                    continue
                # smallest-first: any two terms fit (2*(base-1) <= window)
                col.sort(key=lambda tm: tm[1])
                taken, mx = [], 0
                while col and mx + col[0][1] <= window:
                    ct, v = col.pop(0)
                    taken.append(ct)
                    mx += v
                groups.append((ci, taken, mx))
            batch = torch.stack([sum_cts(g[1]) for g in groups] * 2)
            n = len(groups)
            tables = np.concatenate([np.tile(msg_table(w, m), (n, 1)),
                                     np.tile(carry_table(w, m), (n, 1))])
            ext = self._lut(batch, tables)
            for gi, (ci, _, mx) in enumerate(groups):
                cols[ci].append((ext[gi], base - 1))
                if ci + 1 < d:
                    cols[ci + 1].append((ext[n + gi], mx >> m))
        digits = torch.stack([c[0][0] for c in cols])
        res_max = max(v for c in cols for _, v in c)
        # with width == 2*msg_bits every surviving term is already < base
        # (carries bound by window >> msg_bits): the product is reduced and
        # a final propagation would only burn PBS rounds
        if res_max < base:
            return RadixCiphertext(spec, digits)
        return self.propagate(RadixCiphertext(spec, digits), max_val=res_max)

    def linear_compress(self, xs: torch.Tensor, W,
                        spec: RadixSpec) -> tuple[torch.Tensor, int]:
        """Integer-weight linear layer over a batch of radix vectors,
        reduced to ONE un-propagated digit vector per output column.

        xs: (V_in, D, k*N+1) carry-propagated digit vectors (every digit
        below base); W: integer (V_in, V_out) matrix.  Returns
        (digits, max_val): a (V_out, D, k*N+1) tensor where digits[j]
        represents sum_i W[i, j] * x_i mod 2^bits with every digit's
        plaintext value <= max_val — `propagate(..., max_val=max_val)`
        per output vector finishes the reduction.

        Negative weights lower through the base complement
        (-w*x = |w|*(~x) + |w|, ~x digitwise base-1-d), with the +|w|
        constants collected into one trivial digit-vector term per
        column.  Positive/complement terms then carry-save compress like
        `mul`'s column reduction: each round greedily merges the terms
        whose summed per-digit ceiling fits the 2^width window (one
        group per column), and ALL groups extract (msg, carry) in a
        single `lut_batch`."""
        W = np.asarray(W, np.int64)
        v_in, v_out = W.shape
        d, base, m = spec.n_digits, spec.base, spec.msg_bits
        w_bits = self.params.width
        window = (1 << w_bits) - 1
        assert int(xs.shape[0]) == v_in and int(xs.shape[1]) == d, (
            f"linear_compress: xs {tuple(xs.shape)} vs W {W.shape} x {d} digits")
        # any two compressed terms (ceiling (base-1) + window>>m each) must
        # merge within the window or the reduction stalls: msg_bits == 1
        # (a 2-bit window) cannot host a linear layer
        assert 2 * ((base - 1) + (window >> m)) <= window, (
            f"radix_linear needs carry headroom to merge compressed terms "
            f"(msg_bits={m}, width={w_bits}; use msg_bits >= 2)")

        terms: list = []                 # per column: [(digit_vec, max)]
        for j in range(v_out):
            col: list = []
            negsum = 0
            for i in range(v_in):
                w = int(W[i, j])
                if w == 0:
                    continue
                if w > 0:
                    ct = xs[i] if w == 1 else lwe.scalar_mul(xs[i], w)
                    col.append((ct, w * (base - 1)))
                else:
                    comp = lwe.sub(self._trivial_digits(spec, base - 1),
                                   xs[i])
                    if w < -1:
                        comp = lwe.scalar_mul(comp, -w)
                    col.append((comp, (-w) * (base - 1)))
                    negsum += -w
            if negsum:
                digs = torus.encode(spec.to_digits(negsum).astype(np.int64),
                                    self.params.delta, device=xs.device)
                col.append((lwe.trivial(digs, self.params.big_n), base - 1))
            if not col:
                col.append((self._trivial_digits(spec, 0), 0))
            for _, mx in col:
                assert mx <= window, (
                    f"weight magnitude overflows the digit window "
                    f"(per-digit ceiling {mx} > {window})")
            terms.append(col)

        guard = 0
        max_rounds = 8 * (d + max(len(c) for c in terms)) + 8
        while any(len(c) > 1 for c in terms):
            guard += 1
            assert guard <= max_rounds, "carry-save linear failed to converge"
            groups = []                  # (col, summed ct, group max)
            for j in range(v_out):
                col = terms[j]
                if len(col) < 2:
                    continue
                col.sort(key=lambda tm: tm[1])
                taken, mx = [], 0
                while col and mx + col[0][1] <= window:
                    ct, v = col.pop(0)
                    taken.append(ct)
                    mx += v
                if len(taken) < 2:
                    # no pair fits the window: solo-extract the LARGEST
                    # term instead — its ceiling strictly shrinks (it
                    # must exceed base here, or a pair would have fit),
                    # whereas re-extracting a small term spins forever
                    col.extend(zip(taken, [mx] * len(taken)))
                    col.sort(key=lambda tm: tm[1])
                    ct, mx = col.pop()
                    taken = [ct]
                groups.append((j, sum_cts(taken), mx))
            gn = len(groups)
            gcts = torch.cat([g[1] for g in groups], dim=0)
            batch = torch.cat([gcts, gcts], dim=0)
            tables = np.concatenate(
                [np.tile(msg_table(w_bits, m), (gn * d, 1)),
                 np.tile(carry_table(w_bits, m), (gn * d, 1))])
            out = self._lut(batch, tables)
            msgs = out[:gn * d].reshape(gn, d, -1)
            carries = out[gn * d:].reshape(gn, d, -1)
            for gi, (j, _, mx) in enumerate(groups):
                terms[j].append((_add_shifted(msgs[gi], carries[gi]),
                                 (base - 1) + (mx >> m)))

        digits = torch.stack([c[0][0] for c in terms])
        max_val = max(c[0][1] for c in terms)
        return digits, max_val

    # -- predicates -----------------------------------------------------------
    def compare(self, a: RadixCiphertext, b: RadixCiphertext) -> torch.Tensor:
        """Encrypted three-way compare: one ciphertext holding
        0 (a == b), 1 (a < b) or 2 (a > b).  Per-digit verdicts in one
        batch, then a log-depth lexicographic tree reduce."""
        assert a.spec == b.spec
        spec = a.spec
        w, m = self.params.width, spec.msg_bits
        assert w >= 4, "compare needs width >= 4 (bivariate verdict combine)"
        comb = lwe.add(lwe.scalar_mul(a.digits, spec.base), b.digits)
        cur = self._lut(comb, np.tile(cmp_digit_table(w, m),
                                      (spec.n_digits, 1)))
        while cur.shape[0] > 1:
            n = int(cur.shape[0])
            lo, hi = cur[0:n - 1:2], cur[1:n:2]
            comb = lwe.add(lwe.scalar_mul(hi, 4), lo)
            out = self._lut(comb, np.tile(cmp_combine_table(w),
                                          (comb.shape[0], 1)))
            if n % 2:
                out = torch.cat([out, cur[n - 1:]], dim=0)
            cur = out
        return cur[0]

    def relu_clamp(self, a: RadixCiphertext) -> RadixCiphertext:
        """max(a, 0) for a interpreted as a two's-complement signed
        integer: one sign PBS on the top digit, then one batched masking
        round over all digits."""
        spec = a.spec
        w, m = self.params.width, spec.msg_bits
        sign = self._lut(a.digits[-1:], sign_table(w, m)[None])[0]
        comb = lwe.add(a.digits,
                       lwe.scalar_mul(sign, spec.base).expand_as(a.digits))
        out = self._lut(comb, np.tile(mask_table(w, m), (spec.n_digits, 1)))
        return RadixCiphertext(spec, out)


def sum_cts(cts: list) -> torch.Tensor:
    """Linear sum of LWE ciphertexts (LPU work, no PBS)."""
    acc = cts[0]
    for c in cts[1:]:
        acc = lwe.add(acc, c)
    return acc
