"""Client-side program builders for the serving runtime.  The port of
`repro.serve.programs`.

Thin wrappers over the `repro_torch.api` tracing front door: the graphs
are built by `repro_torch.api.trace_program` from `EncryptedInt`
operator traces, so a program submitted to `ServeRuntime` is the SAME
object a `Session` traces.  A client keeps the secret key; the runtime
only ever sees the compiled graph and big-key digit ciphertexts.
Randomness comes from one `torch.Generator`, drawn from in order, where
the reference splits a JAX key per input.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.api.session import trace_program
from repro_torch.api.tracing import IntSpec
from repro_torch.compiler.ir import Graph
from repro_torch.core.integer import IntegerContext, RadixCiphertext

_BINOPS = {
    "radix_add": lambda a, b: a + b,
    "radix_sub": lambda a, b: a - b,
    "radix_mul": lambda a, b: a * b,
    "radix_cmp": lambda a, b: a.cmp(b),
}

_UNOPS = {
    "radix_relu": lambda a: a.relu(),
}


def radix_binop_program(op: str, bits: int, msg_bits: int) -> Graph:
    """Graph of one radix binary op (radix_add/sub/mul/cmp) over two
    D-digit vectors."""
    spec = IntSpec(bits, msg_bits)
    return trace_program(_BINOPS[op], (spec, spec)).graph


def radix_unop_program(op: str, bits: int, msg_bits: int) -> Graph:
    """Graph of one radix unary op (radix_relu) over a D-digit vector."""
    return trace_program(_UNOPS[op], (IntSpec(bits, msg_bits),)).graph


def fhe_ml_block_program(kind: str, d: int, bits: int, msg_bits: int,
                         seed: int = 0):
    """Mint encrypted-ML serving traffic: lower a `repro_torch.fhe_ml`
    transformer block onto `bits`-wide radix activations, ready for
    `ServeRuntime.submit` / `Session.compile`.

    kind: "gpt2" (single-head block: radix_linear q/k/v, ct*ct attention
    via radix_mul, ReLU MLP) or "mlp" (two-layer ReLU MLP with random
    calibration weights).  Returns (graph, meta) exactly as the
    `repro_torch.fhe_ml.lower` radix lowerings do — meta carries the
    `input_qmax` range certificate, IntSpec in/out specs and plaintext
    oracles.  Example::

        g, meta = fhe_ml_block_program("gpt2", d=2, bits=16, msg_bits=2)
        prog = sess.compile(g, meta["in_specs"], meta["out_specs"])
        handle = sess.submit(prog, enc_inputs)       # backend="serve"
    """
    from repro_torch.fhe_ml import lower
    if kind == "gpt2":
        return lower.lower_gpt2_block_radix(d, bits=bits, msg_bits=msg_bits,
                                            seed=seed)
    if kind == "mlp":
        rng = np.random.default_rng(seed)
        w1 = rng.normal(size=(d, 2 * d)) * 0.5
        w2 = rng.normal(size=(2 * d, d)) * 0.5
        return lower.lower_mlp_radix(w1, w2, bits=bits, msg_bits=msg_bits)
    raise ValueError(f"unknown fhe_ml block kind {kind!r} "
                     "(have 'gpt2', 'mlp')")


def encrypt_request_inputs(ic: IntegerContext, generator: torch.Generator,
                           values: list, bits: int,
                           msg_bits: int | None = None) -> list:
    """Encrypt one integer per graph input, drawing from `generator` in
    order; returns the (D, k*N+1) digit tensors the interpreter consumes."""
    return [ic.encrypt(generator, int(v), bits, msg_bits).digits for v in values]


def decrypt_radix_output(ic: IntegerContext, arr: torch.Tensor, bits: int,
                         msg_bits: int | None = None) -> list:
    """Decrypt an interpreter output of one or more digit vectors back to
    integers (client side)."""
    spec = ic.spec(bits, msg_bits)
    vecs = arr.reshape(-1, spec.n_digits, arr.shape[-1])
    return [ic.decrypt(RadixCiphertext(spec, v)) for v in vecs]
