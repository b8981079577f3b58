"""Plaintext oracle for FHE IR graphs + the legacy executor shim.

The port of `repro.fhe_ml.executor`.  `interpret(graph, inputs, width)`
is the integer-semantics oracle (every value lives mod 2^width, exactly
like the torus encoding; radix nodes operate on digit vectors mod
2^bits), numpy on Python integers as in the reference, so it agrees
with the reference's oracle bit for bit.

The real encrypted execution lives behind the `repro_torch.api` front
door: `repro_torch.api.EagerBackend` is the KS/ACC-dedup executor, and
`Session(ctx, backend=...)` runs the same graph eagerly or through the
serving interpreter.  `FheExecutor` remains as a deprecation shim over
`EagerBackend` so existing callers keep working.
"""
from __future__ import annotations

import warnings

import numpy as np
import torch

# Shared node evaluator: real home is repro_torch.api.backends;
# re-exported here for the callers that predate the front door.
from repro_torch.api.backends import EagerBackend, eval_linear_ct_op  # noqa: F401
from repro_torch.compiler.ir import Graph, RADIX_OPS


# --------------------------------------------------------------------------
# plaintext integer oracle (defines correctness)
# --------------------------------------------------------------------------

def _interpret_radix(n, vals: dict) -> np.ndarray:
    """Integer semantics of one radix node: recombine digit vectors,
    apply the op mod 2^bits, re-digitize (cmp yields verdicts)."""
    m, d = n.attrs["msg_bits"], n.attrs["n_digits"]
    base, mod = 1 << m, 1 << (m * d)
    a = np.asarray(vals[n.inputs[0]]).reshape(-1, d)
    ints_a = [sum(int(dig) << (i * m) for i, dig in enumerate(vec)) % mod
              for vec in a]
    ints_b = None
    if len(n.inputs) == 2:
        b = np.asarray(vals[n.inputs[1]]).reshape(-1, d)
        ints_b = [sum(int(dig) << (i * m) for i, dig in enumerate(vec)) % mod
                  for vec in b]
    if n.op == "radix_cmp":
        return np.array([0 if x == y else (1 if x < y else 2)
                         for x, y in zip(ints_a, ints_b)], np.int64)
    if n.op == "radix_linear":
        W = np.asarray(n.attrs["W"], np.int64)
        res = [int(sum(int(W[i, j]) * ints_a[i]
                       for i in range(W.shape[0]))) % mod
               for j in range(W.shape[1])]
        return np.array([(v >> (i * m)) & (base - 1)
                         for v in res for i in range(d)], np.int64)
    if n.op == "radix_add":
        res = [(x + y) % mod for x, y in zip(ints_a, ints_b)]
    elif n.op == "radix_addc":
        res = [(x + int(n.attrs["const"])) % mod for x in ints_a]
    elif n.op == "radix_mulc":
        res = [(x * int(n.attrs["const"])) % mod for x in ints_a]
    elif n.op == "radix_norm":
        res = ints_a                    # value-preserving renormalization
    elif n.op == "radix_sub":
        res = [(x - y) % mod for x, y in zip(ints_a, ints_b)]
    elif n.op == "radix_mul":
        res = [(x * y) % mod for x, y in zip(ints_a, ints_b)]
    elif n.op == "radix_relu":
        res = [0 if x >= mod // 2 else x for x in ints_a]
    else:
        raise ValueError(n.op)
    return np.array([(v >> (i * m)) & (base - 1)
                     for v in res for i in range(d)], np.int64)


def interpret(g: Graph, inputs: list, width: int,
              check_range: bool = True) -> dict:
    """inputs: list of int arrays (flattened per input node; radix
    inputs are little-endian digit values).  Returns {node_id: int
    array} for every node, values mod 2^width.

    check_range enforces the Concrete compile-time guarantee: every value
    ENTERING a LUT must lie in [0, 2^width) *before* wrapping — outside
    that window real PBS negacyclically flips the result and the plain
    mod-2^w oracle would silently diverge from the encrypted run.
    Linear values are tracked UNBOUNDED for this check and reduced
    mod 2^width only at LUTs/outputs (torus decode semantics).
    """
    mod = 1 << width
    vals: dict = {}              # unbounded integer tracking
    it = iter(inputs)
    for n in g.nodes:
        if n.op == "input":
            vals[n.id] = np.asarray(next(it), np.int64)
        elif n.op == "add":
            vals[n.id] = vals[n.inputs[0]] + vals[n.inputs[1]]
        elif n.op == "sub":
            vals[n.id] = vals[n.inputs[0]] - vals[n.inputs[1]]
        elif n.op == "addc":
            vals[n.id] = vals[n.inputs[0]] + np.asarray(n.attrs["const"],
                                                        np.int64)
        elif n.op == "mulc":
            vals[n.id] = vals[n.inputs[0]] * np.asarray(n.attrs["const"],
                                                        np.int64)
        elif n.op == "linear":
            W = np.asarray(n.attrs["W"], np.int64)
            x = vals[n.inputs[0]].reshape(-1, W.shape[0])
            y = x @ W
            if n.attrs.get("bias") is not None:
                y = y + np.asarray(n.attrs["bias"], np.int64)
            vals[n.id] = y.reshape(-1)
        elif n.op == "lut":
            v = vals[n.inputs[0]]
            if check_range and (v.min() < 0 or v.max() >= mod):
                raise OverflowError(
                    f"LUT input out of [0, {mod}) at node {n.id} "
                    f"(range [{v.min()}, {v.max()}]): PBS would flip "
                    f"negacyclically — resize weights/activation widths")
            t = np.asarray(n.attrs["table"], np.int64)
            vals[n.id] = t[v % mod] % mod
        elif n.op in RADIX_OPS:
            vals[n.id] = _interpret_radix(n, vals)
        elif n.op in ("reshape", "concat"):
            vals[n.id] = vals[n.inputs[0]]
        else:
            raise ValueError(n.op)
    return {k: np.asarray(v) % mod for k, v in vals.items()}


# --------------------------------------------------------------------------
# legacy executor — deprecation shim over repro_torch.api.EagerBackend
# --------------------------------------------------------------------------

class FheExecutor:
    """Deprecated: construct `repro_torch.api.Session(ctx,
    backend="eager")` (or `repro_torch.api.EagerBackend` directly).  This
    shim forwards to `EagerBackend` and preserves the historical surface
    (`run` returning {node_id: ciphertext tensor}, `stats`,
    `encrypt_inputs`, `decrypt`)."""

    def __init__(self, ctx, *, ks_dedup: bool = True, acc_dedup: bool = True):
        self.ctx = ctx
        self.params = ctx.params
        self._backend = EagerBackend(ctx, ks_dedup=ks_dedup,
                                     acc_dedup=acc_dedup)

    @property
    def stats(self) -> dict:
        return self._backend.stats

    # -- client side --------------------------------------------------------
    def encrypt_inputs(self, generator: torch.Generator, inputs: list) -> list:
        """Encrypt one flattened integer array per graph input, drawing
        from `generator` in input order (as `Session.encrypt_inputs`)."""
        return [self.ctx.encrypt(generator,
                                 np.asarray(arr, np.int64).reshape(-1))
                for arr in inputs]

    def decrypt(self, ct) -> np.ndarray:
        return self.ctx.decrypt(ct).cpu().numpy()

    # -- run ------------------------------------------------------------------
    def run(self, g: Graph, enc_inputs: list) -> dict:
        warnings.warn(
            "FheExecutor.run is deprecated — use repro_torch.api.Session"
            "(ctx, backend='eager') / EagerBackend.run",
            DeprecationWarning, stacklevel=2)
        return self._backend.run(g, enc_inputs)
