"""FHELinAlg-style tensor IR (paper Fig. 12: MLIR FHELinAlg dialect).

The port's copy of `repro.compiler.ir`, node for node: numpy only,
so traced graphs equal the reference's.

Values are ciphertext TENSORS (every element an LWE ciphertext); plaintext
constants ride along as numpy arrays.  Ops:

    input   (shape)
    add     (a, b)                    elementwise ct + ct     — no PBS
    sub     (a, b)                                            — no PBS
    addc    (a, const)                ct + plaintext          — no PBS
    mulc    (a, const)                ct * plaintext integer  — no PBS
    linear  (a, W[, b])               const-matrix matmul     — no PBS
    lut     (a, table)                elementwise PBS (the only op that
                                      bootstraps; bivariate LUTs are
                                      pre-combined linearly, footnote 4)
    concat/reshape                    layout only

The tracer below builds graphs from numpy-like code;
`repro_torch.fhe_ml` lowers quantized transformer blocks into it, and
`repro_torch.compiler.passes` lowers graphs to physical Taurus ops with
both dedup passes applied.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np

LINEAR_OPS = ("add", "sub", "addc", "mulc", "linear", "concat", "reshape")

# Radix wide-integer ops (repro_torch.core.integer): a tensor whose LAST axis is
# the little-endian digit vector of a W-bit integer.  Each op expands into
# a fixed schedule of batched-PBS rounds; `radix_round_plan` is the single
# source of truth for that schedule, shared by the lowering in
# `repro_torch.compiler.passes` and by PBS accounting here.
#
# `radix_linear` is the tensor-level op the fhe_ml quantize-to-radix
# bridge lowers linear layers to: a plaintext integer matmul ACROSS the
# vector axis of a (V, D) radix tensor (`IntegerContext.linear_compress`
# + per-output carry propagation).  Unlike the elementwise ops its round
# count depends on the weight matrix, so the node carries `term_maxes`
# (per-term digit ceilings of its worst output column) for the plan.
#
# `radix_addc` / `radix_mulc` are the LPU-ONLY plaintext-constant ops
# (no PBS round at all): they leave the result UN-PROPAGATED, with the
# per-digit plaintext ceiling tracked as the node's `max_val` attr —
# `RadixSpec.from_digits` decrypts such values exactly, so a program
# ending in const ops never bootstraps for them.  `radix_norm` is the
# explicit renormalization (`IntegerContext.propagate(max_val=...)`)
# the tracer inserts when an un-propagated value feeds a PBS op whose
# digit packing assumes values below base.
RADIX_OPS = ("radix_add", "radix_sub", "radix_mul", "radix_relu",
             "radix_cmp", "radix_linear", "radix_addc", "radix_mulc",
             "radix_norm")


def _ceil_log2(n: int) -> int:
    return max(0, (n - 1).bit_length())


def radix_round_plan(op: str, n_digits: int, msg_bits: Optional[int] = None,
                     width: Optional[int] = None,
                     term_maxes: Optional[tuple] = None,
                     max_val: Optional[int] = None) -> list:
    """Batched-PBS rounds of one radix op over a D-digit vector,
    mirroring the carry strategy `IntegerContext.propagate` auto-selects.
    Each round is a dict:
      luts     PBS applications in the round's single batch
      sources  distinct input ciphertexts feeding those LUTs (the
               key-switch count after KS-dedup: fanout shares one KS)
      tables   symbolic accumulator-table ids (ACC-dedup keys)
      macs     LPU MACs of the round's linear stitch-up

    msg_bits selects the carry strategy the runtime will take: the
    runtime decides on the parameter set's plaintext window, which the
    params-free IR does not know, so the model assumes the standard
    width = 2*msg_bits layout unless `width` is given explicitly.
    Wide windows (msg_bits >= 2 / width >= 4, or msg_bits None — the
    historical default) take the packed Hillis-Steele prefix scan;
    narrow windows take the two-level carry-lookahead scan where
    2 + 2*ceil(log2 D) beats D, else ripple.  (Base-2 programs were
    previously costed with the prefix plan, which under-counted their
    rounds.)  Single-digit vectors are one ripple extraction round for
    every strategy, exactly like the runtime.
    """
    d = n_digits

    def ripple_plan(rounds):
        return [{"luts": 2 * d, "sources": d,
                 "tables": ("radix/msg", "radix/carry"), "macs": d}
                for _ in range(rounds)]

    def add_plan():
        if d == 1:
            return ripple_plan(1)
        if width is not None:
            narrow = width < 4
        else:
            narrow = msg_bits == 1        # standard width = 2*msg_bits
        if not narrow:
            rounds = [{"luts": 2 * d, "sources": d,
                       "tables": ("radix/msg", "radix/sigma"), "macs": d}]
            for _ in range(_ceil_log2(d)):
                rounds.append({"luts": d, "sources": d,
                               "tables": ("radix/combine",), "macs": d})
            rounds.append({"luts": d, "sources": d,
                           "tables": ("radix/msg",), "macs": d})
            return rounds
        if 2 + 2 * _ceil_log2(d) < d:
            # two-level lookahead: status kept as (generate, propagate)
            # bit pairs, each scan level two batched bit-logic rounds
            rounds = [{"luts": 3 * d, "sources": d,
                       "tables": ("radix/msg", "radix/generate",
                                  "radix/propagate"), "macs": d}]
            dd = 1
            while dd < d:
                k = d - dd
                # round A: AND terms + propagate combine; lanes below the
                # scan distance refresh through the bit identity.  Every
                # row is a fresh LPU combination -> no KS sharing.
                rounds.append({"luts": 2 * k + dd, "sources": 2 * k + dd,
                               "tables": ("radix/bit_and", "radix/bit_or"),
                               "macs": 2 * k})
                # round B: fold the lookahead term into generate
                rounds.append({"luts": d, "sources": d,
                               "tables": ("radix/bit_or",), "macs": k})
                dd *= 2
            rounds.append({"luts": d, "sources": d,
                           "tables": ("radix/msg",), "macs": d})
            return rounds
        # ripple: D batched (msg, carry) extraction rounds
        return ripple_plan(d)

    if op in ("radix_addc", "radix_mulc"):
        return []                         # LPU-only: no PBS round at all
    if op == "radix_norm":
        # mirrors `IntegerContext.propagate(max_val=...)`: batched
        # (msg, carry) pre-extraction rounds fold the digit ceiling down
        # to 2*base-2, then the add-style carry scan finishes
        m = msg_bits if msg_bits is not None else 2
        w_eff = width if width is not None else 2 * m
        base = 1 << m
        mv = max_val if max_val is not None else (1 << w_eff) - 1
        rounds = []
        while mv > 2 * base - 2:
            mv = (base - 1) + (mv >> m)
            rounds.append({"luts": 2 * d, "sources": d,
                           "tables": ("radix/msg", "radix/carry"),
                           "macs": d})
        return rounds + add_plan()
    if op in ("radix_add", "radix_sub"):
        return add_plan()
    if op == "radix_linear":
        # Mirrors `IntegerContext.linear_compress`: the weighted digit
        # vectors are LPU-combined into per-output term lists; each round
        # greedily merges, per column, the terms whose summed digit
        # ceiling fits the plaintext window and extracts (msg, carry)
        # for the merged groups; the surviving terms then pre-reduce and
        # carry-propagate exactly like an add.  `term_maxes` is the
        # per-column tuple of per-term ceilings recorded on the node at
        # trace time (a flat tuple of ints is accepted as one column) —
        # compression rounds run until EVERY column is down to one term,
        # so the count is the max over columns, like the runtime.
        m = msg_bits if msg_bits is not None else 2
        w_eff = width if width is not None else 2 * m
        window = (1 << w_eff) - 1
        base = 1 << m
        extract = {"luts": 2 * d, "sources": d,
                   "tables": ("radix/msg", "radix/carry"), "macs": d}
        rounds = []
        if term_maxes and isinstance(term_maxes[0], (tuple, list)):
            cols = [sorted(c) if c else [0] for c in term_maxes]
        else:
            cols = [sorted(term_maxes) if term_maxes else [base - 1]]
        guard = 0
        max_rounds = 8 * (d + max(len(c) for c in cols)) + 8
        while any(len(c) > 1 for c in cols):
            guard += 1
            assert guard <= max_rounds, "radix_linear plan failed to converge"
            for c in cols:
                if len(c) < 2:
                    continue
                c.sort()
                taken, mx = 0, 0
                while taken < len(c) and mx + c[taken] <= window:
                    mx += c[taken]
                    taken += 1
                if taken < 2:
                    # no pair fits: solo-extract the LARGEST term
                    # (mirrors linear_compress — its ceiling shrinks)
                    mx = c.pop()
                else:
                    del c[:taken]
                c.append((base - 1) + (mx >> m))
            rounds.append(dict(extract))
        mv = max(c[0] for c in cols)
        while mv > 2 * base - 2:
            mv = (base - 1) + (mv >> m)
            rounds.append(dict(extract))
        return rounds + add_plan()
    if op == "radix_mul":
        t = d * (d + 1) // 2
        rounds = [{"luts": 2 * t, "sources": t,
                   "tables": ("radix/pp_lo", "radix/pp_hi"), "macs": 2 * t}]
        for _ in range(_ceil_log2(d) + 1):       # carry-save compression
            rounds.append({"luts": 2 * d, "sources": d,
                           "tables": ("radix/msg", "radix/carry"),
                           "macs": 2 * d})
        # no trailing propagation: with the standard msg/carry split the
        # compression already leaves every digit < base
        return rounds
    if op == "radix_relu":
        return [{"luts": 1, "sources": 1, "tables": ("radix/sign",), "macs": 0},
                {"luts": d, "sources": d, "tables": ("radix/mask",), "macs": d}]
    if op == "radix_cmp":
        rounds = [{"luts": d, "sources": d, "tables": ("radix/cmp",),
                   "macs": d}]
        n = d
        while n > 1:
            # odd lane counts: the leftover verdict passes through with no
            # PBS, so only floor(n/2) combines dispatch
            rounds.append({"luts": n // 2, "sources": n // 2,
                           "tables": ("radix/cmp_combine",), "macs": n // 2})
            n = -(-n // 2)
        return rounds
    raise ValueError(op)


def radix_vectors(node) -> int:
    """How many independent digit vectors a radix node processes.  cmp
    collapses the digit axis, so its OUTPUT already counts vectors."""
    if node.op == "radix_cmp":
        return node.n_elements
    return node.n_elements // node.attrs["n_digits"]


@dataclasses.dataclass
class Node:
    id: int
    op: str
    inputs: tuple            # node ids
    shape: tuple
    attrs: dict = dataclasses.field(default_factory=dict)

    @property
    def n_elements(self) -> int:
        n = 1
        for d in self.shape:
            n *= d
        return n


@dataclasses.dataclass
class Graph:
    nodes: list = dataclasses.field(default_factory=list)
    outputs: list = dataclasses.field(default_factory=list)

    def add(self, op: str, inputs: tuple, shape: tuple, **attrs) -> Node:
        node = Node(len(self.nodes), op, inputs, tuple(shape), attrs)
        self.nodes.append(node)
        return node

    def users(self) -> dict:
        out: dict = {n.id: [] for n in self.nodes}
        for n in self.nodes:
            for i in n.inputs:
                out[i].append(n.id)
        return out

    # -- statistics ---------------------------------------------------------
    def count(self, op: str) -> int:
        return sum(1 for n in self.nodes if n.op == op)

    def lut_applications(self) -> int:
        """Total element-level PBS operations (before any dedup)."""
        total = sum(n.n_elements for n in self.nodes if n.op == "lut")
        for n in self.nodes:
            if n.op in RADIX_OPS:
                total += radix_vectors(n) * sum(
                    r["luts"]
                    for r in radix_round_plan(
                        n.op, n.attrs["n_digits"], n.attrs.get("msg_bits"),
                        term_maxes=n.attrs.get("term_maxes"),
                        max_val=n.attrs.get("max_val")))
        return total


class FheTensor:
    """Tracing handle: numpy-like ops recorded into a Graph."""

    def __init__(self, graph: Graph, node: Node):
        self.graph = graph
        self.node = node

    @property
    def shape(self):
        return self.node.shape

    def _bin(self, other: "FheTensor", op: str) -> "FheTensor":
        assert self.shape == other.shape, (self.shape, other.shape)
        n = self.graph.add(op, (self.node.id, other.node.id), self.shape)
        return FheTensor(self.graph, n)

    def __add__(self, other):
        if isinstance(other, FheTensor):
            return self._bin(other, "add")
        n = self.graph.add("addc", (self.node.id,), self.shape,
                           const=np.asarray(other))
        return FheTensor(self.graph, n)

    def __sub__(self, other):
        if isinstance(other, FheTensor):
            return self._bin(other, "sub")
        return self + (-np.asarray(other))

    def __mul__(self, const):
        assert not isinstance(const, FheTensor), \
            "ct*ct needs a bivariate LUT — use lut2()"
        n = self.graph.add("mulc", (self.node.id,), self.shape,
                           const=np.asarray(const))
        return FheTensor(self.graph, n)

    def linear(self, W: np.ndarray, bias: Optional[np.ndarray] = None):
        """x @ W (+ bias): W integer plaintext (in_dim, out_dim)."""
        assert self.shape[-1] == W.shape[0]
        shape = self.shape[:-1] + (W.shape[1],)
        n = self.graph.add("linear", (self.node.id,), shape, W=W, bias=bias)
        return FheTensor(self.graph, n)

    def lut(self, table: np.ndarray, name: str = ""):
        """Elementwise programmable bootstrap with `table`."""
        n = self.graph.add("lut", (self.node.id,), self.shape,
                           table=np.asarray(table), name=name)
        return FheTensor(self.graph, n)

    def lut2(self, other: "FheTensor", table: np.ndarray, radix: int,
             name: str = ""):
        """Bivariate LUT (paper footnote 4): combine linearly then one PBS.
        encoded = a * radix + b; table indexed by the combined value."""
        comb = (self * radix)._bin(other, "add")
        return comb.lut(table, name=name)

    def reshape(self, *shape):
        n = self.graph.add("reshape", (self.node.id,), shape)
        return FheTensor(self.graph, n)

    # -- radix wide-integer ops (last axis = digit vector) ------------------
    def _radix_bin(self, other: "FheTensor", op: str, msg_bits: int):
        assert self.shape == other.shape and self.shape, (
            "radix ops need matching digit-vector shapes")
        n = self.graph.add(op, (self.node.id, other.node.id), self.shape,
                           msg_bits=msg_bits, n_digits=self.shape[-1])
        return FheTensor(self.graph, n)

    def radix_add(self, other, msg_bits: int):
        """Carry-propagated wide-integer add over the digit axis."""
        return self._radix_bin(other, "radix_add", msg_bits)

    def radix_sub(self, other, msg_bits: int):
        return self._radix_bin(other, "radix_sub", msg_bits)

    def radix_mul(self, other, msg_bits: int):
        """Schoolbook wide-integer product mod 2^(msg_bits * D)."""
        return self._radix_bin(other, "radix_mul", msg_bits)

    def radix_relu(self, msg_bits: int):
        """Two's-complement max(x, 0) over the digit vector."""
        n = self.graph.add("radix_relu", (self.node.id,), self.shape,
                           msg_bits=msg_bits, n_digits=self.shape[-1])
        return FheTensor(self.graph, n)

    def radix_linear(self, W: np.ndarray, msg_bits: int) -> "FheTensor":
        """Plaintext integer matmul ACROSS the vector axis of a radix
        tensor: out[j] = sum_i W[i, j] * self[i] mod 2^bits, each output
        vector carry-propagated back below base.

        Input shape (V_in, D) -> output (W.shape[1], D); W is an integer
        (V_in, V_out) matrix (negative weights lower through the base
        complement, so two's-complement semantics hold as long as the
        true accumulator magnitude stays below 2^(bits-1) — the
        `repro_torch.fhe_ml.quantize` range check enforces that bound)."""
        W = np.asarray(W, np.int64)
        assert len(self.shape) == 2 and self.shape[0] == W.shape[0], (
            f"radix_linear needs a (V_in, D) digit tensor matching W rows: "
            f"{self.shape} vs W {W.shape}")
        d = self.shape[-1]
        base = 1 << msg_bits
        # per-column per-term digit ceilings, recorded for
        # `radix_round_plan`: |w|*(base-1) per nonzero weight, plus one
        # trivial term carrying the two's-complement +|w| constants when
        # the column has negative weights (compression rounds run until
        # every column is reduced, so the plan needs them all)
        cols = []
        for j in range(W.shape[1]):
            col = [abs(int(w)) * (base - 1) for w in W[:, j] if w]
            if bool((W[:, j] < 0).any()):
                col.append(base - 1)
            cols.append(tuple(col) if col else (0,))
        n = self.graph.add("radix_linear", (self.node.id,),
                           (W.shape[1], d), W=W, msg_bits=msg_bits,
                           n_digits=d, term_maxes=tuple(cols))
        return FheTensor(self.graph, n)

    def radix_addc(self, const: int, msg_bits: int,
                   max_val: int) -> "FheTensor":
        """Add a plaintext constant digitwise — LPU only, NO carry
        propagation: the result's per-digit ceiling is `max_val`
        (recorded on the node; `from_digits` still decrypts exactly)."""
        n = self.graph.add("radix_addc", (self.node.id,), self.shape,
                           const=int(const), msg_bits=msg_bits,
                           n_digits=self.shape[-1], max_val=int(max_val))
        return FheTensor(self.graph, n)

    def radix_mulc(self, const: int, msg_bits: int,
                   max_val: int) -> "FheTensor":
        """Multiply by a non-negative plaintext integer digitwise — LPU
        only, NO carry propagation (`max_val` = resulting digit ceiling)."""
        n = self.graph.add("radix_mulc", (self.node.id,), self.shape,
                           const=int(const), msg_bits=msg_bits,
                           n_digits=self.shape[-1], max_val=int(max_val))
        return FheTensor(self.graph, n)

    def radix_norm(self, msg_bits: int, max_val: int) -> "FheTensor":
        """Carry-propagate an un-normalized digit vector back below base
        (`max_val` = the INPUT's digit ceiling, what the runtime's
        `propagate(max_val=...)` receives)."""
        n = self.graph.add("radix_norm", (self.node.id,), self.shape,
                           msg_bits=msg_bits, n_digits=self.shape[-1],
                           max_val=int(max_val))
        return FheTensor(self.graph, n)

    def radix_cmp(self, other, msg_bits: int):
        """Three-way compare -> one ciphertext per digit vector."""
        assert self.shape == other.shape and self.shape
        n = self.graph.add("radix_cmp", (self.node.id, other.node.id),
                           self.shape[:-1] + (1,),
                           msg_bits=msg_bits, n_digits=self.shape[-1])
        return FheTensor(self.graph, n)


def trace(fn, *input_shapes):
    """Run `fn(x1, x2, ...)` on tracing tensors; returns the Graph."""
    g = Graph()
    args = [FheTensor(g, g.add("input", (), s)) for s in input_shapes]
    out = fn(*args)
    outs = out if isinstance(out, (tuple, list)) else (out,)
    g.outputs = [t.node.id for t in outs]
    return g
