"""Tracing types of the `Session` front door.

The port's copy of `repro.api.tracing` (numpy only): the same
operators record the same IR nodes.

`EncryptedInt` and `EncryptedTensor` are the values a traced function
manipulates: thin wrappers over `repro_torch.compiler.ir.FheTensor` whose
Python operators record IR nodes instead of computing.  An
`EncryptedInt` is a radix wide integer — its last tensor axis is the
little-endian digit vector (`repro_torch.core.integer`), and `+`, `-`, `*`,
comparisons and `relu()` record `radix_*` nodes.  An `EncryptedTensor`
is a tensor of plain width-bit ciphertext slots — the
`repro_torch.fhe_ml` value kind — and records the linear/`lut` nodes `FheTensor` already
implements.

The specs (`IntSpec`, `TensorSpec`, `RawSpec`) describe program inputs
and outputs; `Session` uses them to encrypt arguments and decrypt
results, so one `Program` means the same plaintexts on every backend.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from repro_torch.compiler.ir import FheTensor, Graph


def _prod(shape) -> int:
    n = 1
    for d in shape:
        n *= d
    return n


@dataclasses.dataclass(frozen=True)
class IntSpec:
    """A (tensor of) encrypted W-bit radix integer(s).

    shape is the LEADING shape — () for one integer, (V,) for a vector
    of V integers; the traced tensor gains a trailing digit axis of
    length `bits // msg_bits`.  msg_bits defaults per parameter set
    (half the plaintext window) when the spec reaches a `Session`.

    Example::

        prog = sess.trace(lambda a, b: a + b,
                          IntSpec(16), IntSpec(16))          # scalars
        prog = sess.trace(lambda v: v.linear(W).relu(),
                          IntSpec(32, shape=(8,)))           # a vector
    """
    bits: int
    msg_bits: Optional[int] = None
    shape: tuple = ()

    def resolve(self, params) -> "IntSpec":
        if self.msg_bits is not None:
            return self
        return dataclasses.replace(
            self, msg_bits=max(1, params.width // 2))

    @property
    def n_digits(self) -> int:
        assert self.msg_bits is not None, "unresolved IntSpec (no msg_bits)"
        return self.bits // self.msg_bits

    @property
    def n_ints(self) -> int:
        return _prod(self.shape)

    @property
    def tensor_shape(self) -> tuple:
        return tuple(self.shape) + (self.n_digits,)

    @property
    def modulus(self) -> int:
        return 1 << self.bits


@dataclasses.dataclass(frozen=True)
class TensorSpec:
    """A tensor of ordinary width-bit ciphertext slots (the fhe_ml value
    kind: quantized activations, LUT inputs/outputs)."""
    shape: tuple

    @property
    def n_elements(self) -> int:
        return _prod(self.shape)


@dataclasses.dataclass(frozen=True)
class RawSpec:
    """An output of raw ciphertext slots decrypted elementwise — compare
    verdicts, comparison bits, anything not carrying radix layout."""
    shape: tuple

    @property
    def n_elements(self) -> int:
        return _prod(self.shape)


class EncryptedValue:
    """Raw ciphertext-slot handle (cmp verdicts / comparison bits): still
    traceable through elementwise `lut`."""

    def __init__(self, t: FheTensor):
        self.t = t

    @property
    def shape(self):
        return self.t.shape

    def lut(self, table, name: str = "") -> "EncryptedValue":
        return EncryptedValue(self.t.lut(np.asarray(table), name=name))

    def out_spec(self) -> RawSpec:
        return RawSpec(tuple(self.shape))


# cmp verdict encoding (repro_torch.core.integer.cmp_digit_table):
#   0 = equal, 1 = less-than, 2 = greater-than
_VERDICT_BITS = {
    "lt": (1,), "gt": (2,), "eq": (0,),
    "le": (0, 1), "ge": (0, 2), "ne": (1, 2),
}


def _verdict_table(width: int, which: str) -> np.ndarray:
    hot = _VERDICT_BITS[which]
    return np.array([1 if v in hot else 0 for v in range(1 << width)],
                    dtype=np.uint64)


class EncryptedInt:
    """Traced radix wide integer: operators record `radix_*` IR nodes.

    `width` (the parameter set's plaintext window) is only needed by the
    boolean comparisons, whose verdict-to-bit LUT is a 2^width table;
    `Session.trace` always supplies it, the session-free
    `trace_program(..., params=None)` path leaves it unset.

    Plaintext-constant operands (`enc + 3`, `enc * 2`, `enc - 5`) record
    LPU-only `radix_addc`/`radix_mulc` nodes — no PBS round.  The result
    is left UN-PROPAGATED: `max_val` tracks its per-digit plaintext
    ceiling (decryption recombines exactly regardless), and a
    `radix_norm` node (one carry propagation) is auto-inserted only when
    an un-normalized value feeds a PBS op whose digit packing assumes
    values below base.
    """

    def __init__(self, t: FheTensor, spec: IntSpec,
                 width: Optional[int] = None,
                 max_val: Optional[int] = None):
        assert spec.msg_bits is not None, "IntSpec must be resolved"
        assert tuple(t.shape) == spec.tensor_shape, (t.shape, spec)
        self.t = t
        self.spec = spec
        self.width = width
        # per-digit plaintext ceiling; base-1 == carry-propagated
        self.max_val = ((1 << spec.msg_bits) - 1
                        if max_val is None else int(max_val))

    @property
    def shape(self):
        return self.spec.shape

    @property
    def _window(self) -> int:
        """Largest per-digit plaintext value the parameter set can hold.
        Without a session (width unknown) assume the standard
        width = 2*msg_bits layout — conservative: a wider real window
        only makes the extra norms sound, never wrong."""
        w = self.width if self.width is not None else 2 * self.spec.msg_bits
        return (1 << w) - 1

    def norm(self) -> "EncryptedInt":
        """Carry-propagate back below base (PBS rounds); no-op when the
        digits are already normalized."""
        base = 1 << self.spec.msg_bits
        if self.max_val <= base - 1:
            return self
        return EncryptedInt(
            self.t.radix_norm(self.spec.msg_bits, self.max_val),
            self.spec, self.width)

    # -- arithmetic (each one radix node over the digit axis) ---------------
    def _coerce(self, other) -> "EncryptedInt":
        if not isinstance(other, EncryptedInt):
            raise TypeError(
                f"EncryptedInt ops need EncryptedInt or int operands, got "
                f"{type(other).__name__} (encrypt non-integer plaintext "
                f"as program inputs)")
        assert other.spec == self.spec, (self.spec, other.spec)
        return other

    def _addc(self, const: int) -> "EncryptedInt":
        c = int(const) % self.spec.modulus
        if c == 0:
            return self
        m = self.spec.msg_bits
        base = 1 << m
        cmax = max((c >> (i * m)) & (base - 1)
                   for i in range(self.spec.n_digits))
        s = self if self.max_val + cmax <= self._window else self.norm()
        out_max = s.max_val + cmax
        return EncryptedInt(s.t.radix_addc(c, m, out_max),
                            self.spec, self.width, max_val=out_max)

    def _mulc(self, const: int) -> "EncryptedInt":
        k = int(const)
        if k < 0:
            raise TypeError(
                "negative plaintext multipliers are not supported "
                "(digitwise scaling has no base complement) — encrypt "
                "the constant as a program input")
        if k == 1:
            return self
        base = 1 << self.spec.msg_bits
        s = self if k * self.max_val <= self._window else self.norm()
        if k * s.max_val > self._window:
            raise TypeError(
                f"plaintext multiplier {k} overflows the digit window "
                f"(ceiling {k * s.max_val} > {self._window}) — encrypt "
                f"it as a program input and use ct*ct multiply")
        out_max = k * s.max_val
        return EncryptedInt(s.t.radix_mulc(k, self.spec.msg_bits, out_max),
                            self.spec, self.width, max_val=out_max)

    def __add__(self, other):
        if isinstance(other, (int, np.integer)):
            return self._addc(other)
        o = self._coerce(other)
        a, b = self.norm(), o.norm()
        return EncryptedInt(a.t.radix_add(b.t, self.spec.msg_bits),
                            self.spec, self.width)

    __radd__ = __add__

    def __sub__(self, other):
        if isinstance(other, (int, np.integer)):
            return self._addc(-int(other))
        o = self._coerce(other)
        a, b = self.norm(), o.norm()
        return EncryptedInt(a.t.radix_sub(b.t, self.spec.msg_bits),
                            self.spec, self.width)

    def __mul__(self, other):
        if isinstance(other, (int, np.integer)):
            return self._mulc(other)
        o = self._coerce(other)
        a, b = self.norm(), o.norm()
        return EncryptedInt(a.t.radix_mul(b.t, self.spec.msg_bits),
                            self.spec, self.width)

    __rmul__ = __mul__

    def relu(self) -> "EncryptedInt":
        """Two's-complement max(x, 0)."""
        s = self.norm()
        return EncryptedInt(s.t.radix_relu(self.spec.msg_bits),
                            self.spec, self.width)

    def linear(self, W) -> "EncryptedInt":
        """Plaintext integer matmul across the integer-vector axis: for a
        vector of V encrypted integers and an integer (V, V_out) matrix,
        out[j] = sum_i W[i, j] * self[i] mod 2^bits (a `radix_linear`
        node — the quantize-to-radix linear layer of
        `repro_torch.fhe_ml`).

        Example::

            prog = sess.trace(lambda x: x.linear(W).relu(),
                              IntSpec(16, shape=(4,)))
        """
        W = np.asarray(W, np.int64)
        if len(self.spec.shape) != 1:
            raise TypeError(
                f"linear needs a 1-D vector of encrypted integers "
                f"(IntSpec shape (V,)), got shape {self.spec.shape}")
        out_spec = dataclasses.replace(self.spec, shape=(int(W.shape[1]),))
        s = self.norm()
        return EncryptedInt(s.t.radix_linear(W, self.spec.msg_bits),
                            out_spec, self.width)

    # -- comparisons ---------------------------------------------------------
    def cmp(self, other) -> EncryptedValue:
        """Three-way compare: 0 equal / 1 less / 2 greater per integer."""
        o = self._coerce(other)
        a, b = self.norm(), o.norm()
        return EncryptedValue(a.t.radix_cmp(b.t, self.spec.msg_bits))

    def _cmp_bit(self, other, which: str) -> EncryptedValue:
        if self.width is None:
            raise TypeError(
                "boolean comparisons need the parameter width for their "
                "verdict LUT — trace through Session.trace (or use .cmp() "
                "for the raw three-way verdict)")
        return self.cmp(other).lut(_verdict_table(self.width, which),
                                   name=f"cmp_{which}")

    def __lt__(self, other):
        return self._cmp_bit(other, "lt")

    def __gt__(self, other):
        return self._cmp_bit(other, "gt")

    def __le__(self, other):
        return self._cmp_bit(other, "le")

    def __ge__(self, other):
        return self._cmp_bit(other, "ge")

    def __eq__(self, other):  # noqa: PLW3201 — traced, numpy-style
        return self._cmp_bit(other, "eq")

    def __ne__(self, other):  # noqa: PLW3201
        return self._cmp_bit(other, "ne")

    __hash__ = None  # traced values are not hashable (eq is symbolic)

    def out_spec(self) -> IntSpec:
        return self.spec


class EncryptedTensor:
    """Traced tensor of width-bit slots — delegates to `FheTensor` and
    re-wraps, so the fhe_ml linear/LUT programming model flows through
    the same Session front door as the radix integers."""

    def __init__(self, t: FheTensor, spec: Optional[TensorSpec] = None):
        self.t = t
        self.spec = spec if spec is not None else TensorSpec(tuple(t.shape))

    @property
    def shape(self):
        return self.t.shape

    def _wrap(self, t: FheTensor) -> "EncryptedTensor":
        return EncryptedTensor(t)

    def __add__(self, other):
        o = other.t if isinstance(other, EncryptedTensor) else other
        return self._wrap(self.t + o)

    def __sub__(self, other):
        o = other.t if isinstance(other, EncryptedTensor) else other
        return self._wrap(self.t - o)

    def __mul__(self, const):
        assert not isinstance(const, (EncryptedTensor, EncryptedInt)), \
            "ct*ct needs a bivariate LUT — use lut2()"
        return self._wrap(self.t * const)

    def linear(self, W, bias=None):
        return self._wrap(self.t.linear(np.asarray(W), bias))

    def lut(self, table, name: str = ""):
        return self._wrap(self.t.lut(np.asarray(table), name=name))

    def lut2(self, other: "EncryptedTensor", table, radix: int,
             name: str = ""):
        return self._wrap(self.t.lut2(other.t, np.asarray(table), radix,
                                      name=name))

    def reshape(self, *shape):
        return self._wrap(self.t.reshape(*shape))

    def out_spec(self) -> TensorSpec:
        return TensorSpec(tuple(self.shape))


def make_input(graph: Graph, spec, width: Optional[int] = None):
    """Create one traced input value for `spec` in `graph`."""
    if isinstance(spec, IntSpec):
        node = graph.add("input", (), spec.tensor_shape)
        return EncryptedInt(FheTensor(graph, node), spec, width)
    if isinstance(spec, TensorSpec):
        node = graph.add("input", (), spec.shape)
        return EncryptedTensor(FheTensor(graph, node), spec)
    raise TypeError(f"unknown input spec {spec!r}")
