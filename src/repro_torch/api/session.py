"""The `Session` front door: trace once, run anywhere.

The port of `repro.api.session`.  A `Session` binds key material (a
`TFHEContext`) to one pluggable `Backend` and gives every FHE workload
the same three-step shape:

    sess = Session(ctx, backend="local", kernel_backend="fused")
    prog = sess.trace(lambda a, b: (a * b).relu(), IntSpec(16), IntSpec(16))
    enc  = sess.encrypt_inputs(generator, [x, y], prog)
    out  = sess.run(prog, enc)
    vals = sess.decrypt_outputs(prog, out)

The traced `Program` is an ordinary `repro_torch.compiler.ir.Graph` plus
the input/output specs needed to encrypt and decrypt.  Swapping
`backend="eager" | "local" | "serve"` changes WHERE the graph executes
(direct `IntegerContext`, the serving IR interpreter, or the multi-tenant
`ServeRuntime`), never WHAT it computes.
Randomness comes from one `torch.Generator`, drawn from in order, where
the reference splits a JAX key per input and per integer.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.api.tracing import (EncryptedInt, EncryptedTensor, EncryptedValue,
                                     IntSpec, RawSpec, TensorSpec, make_input)
from repro_torch.compiler.ir import Graph
from repro_torch.core.integer import IntegerContext, RadixCiphertext


@dataclasses.dataclass
class Program:
    """A compiled program: the IR graph plus its encryption contract."""
    graph: Graph
    in_specs: list
    out_specs: list

    @classmethod
    def from_graph(cls, graph: Graph, in_specs: Optional[list] = None,
                   out_specs: Optional[list] = None) -> "Program":
        """Wrap a hand-built / lowered Graph.  Specs default to plain
        tensor/raw slots shaped like the graph's input and output nodes."""
        if in_specs is None:
            in_specs = [TensorSpec(tuple(n.shape)) for n in graph.nodes
                        if n.op == "input"]
        if out_specs is None:
            out_specs = [RawSpec(tuple(graph.nodes[o].shape))
                         for o in graph.outputs]
        return cls(graph, list(in_specs), list(out_specs))

    @property
    def n_inputs(self) -> int:
        return len(self.in_specs)


def trace_program(fn, in_specs, params=None) -> Program:
    """Trace `fn` over input specs into a `Program`.

    Without `params`, IntSpecs must carry explicit msg_bits and boolean
    comparisons are unavailable (their verdict LUT needs the plaintext
    width).
    """
    width = params.width if params is not None else None
    g = Graph()
    specs = [s.resolve(params) if isinstance(s, IntSpec) and params is not None
             else s for s in in_specs]
    args = [make_input(g, s, width) for s in specs]
    out = fn(*args)
    outs = list(out) if isinstance(out, (tuple, list)) else [out]
    out_specs = []
    for o in outs:
        if not isinstance(o, (EncryptedInt, EncryptedTensor, EncryptedValue)):
            raise TypeError(f"traced fn returned {type(o).__name__}; "
                            "return traced encrypted values")
        out_specs.append(o.out_spec())
    g.outputs = [o.t.node.id for o in outs]
    return Program(g, specs, out_specs)


class Session:
    """One front door for eager, in-process and served FHE execution.

    backend: "eager" | "local" | "serve", or any object implementing the
    `Backend` protocol (`execute(program, enc_inputs) -> outputs`).  Extra
    keyword arguments are forwarded to the named backend's constructor
    (e.g. `fused=True` for local, `max_inflight=8` or `shards=2` for
    serve).  `with Session(...) as sess:` closes the backend (a serve
    session's runtime) on exit.

    kernel_backend: "fused" | "reference" — which PBS engine room the
    session's `TaurusEngine` runs (see `repro_torch.core.engine`).  Only
    valid when no prebuilt engine is passed.  Without either, the session
    builds a fused engine on the keys' device.

    telemetry: an optional duck-typed telemetry object threaded through
    the named backend's stack (interpreter, integer context).

    Example (`sess(prog, generator, *vals)` collapses encrypt -> run ->
    decrypt)::

        gen = torch.Generator(device="cuda").manual_seed(0)
        sess = Session(ctx, backend="local", kernel_backend="fused")
        prog = sess.trace(lambda a, b: a + b, IntSpec(16), IntSpec(16))
        print(sess(prog, gen, 1234, 567))   # [1801]
    """

    def __init__(self, ctx, engine=None, backend="local", telemetry=None,
                 kernel_backend=None, **backend_kw):
        from repro_torch.api.backends import make_backend
        from repro_torch.core.engine import TaurusEngine
        self.ctx = ctx
        self.params = ctx.params
        if kernel_backend is not None:
            if engine is not None:
                raise TypeError("pass kernel_backend OR a prebuilt engine, "
                                "not both (set it on the engine instead)")
            engine = TaurusEngine.from_context(ctx, kernel_backend=kernel_backend,
                                               device=ctx.device)
        # client-side radix crypto (encrypt/decrypt only — backends own
        # their server-side contexts)
        self.int_ctx = IntegerContext.create(ctx, engine)
        self.engine = self.int_ctx.engine
        if isinstance(backend, str):
            if telemetry is not None:
                backend_kw["telemetry"] = telemetry
            backend = make_backend(backend, ctx, self.engine, **backend_kw)
        elif backend_kw or telemetry is not None:
            raise TypeError("backend_kw/telemetry only apply to named "
                            "backends (pass telemetry to the backend's own "
                            "constructor instead)")
        self.backend = backend
        self.telemetry = telemetry if telemetry is not None \
            else getattr(backend, "telemetry", None)

    def metrics(self) -> dict:
        """The backend's telemetry snapshot ({} for an un-instrumented
        backend object)."""
        return self.telemetry.snapshot() if self.telemetry is not None else {}

    # -- trace / compile -----------------------------------------------------
    def trace(self, fn, *in_specs) -> Program:
        """Trace `fn` over the given specs into a backend-portable
        Program.  IntSpec msg_bits defaults from this session's params."""
        return trace_program(fn, in_specs, self.params)

    def compile(self, graph: Graph, in_specs=None, out_specs=None) -> Program:
        """Adopt an existing IR graph as a backend-portable Program.
        Without specs, inputs/outputs default to plain width-bit
        ciphertext-slot tensors shaped like the graph's input/output
        nodes; radix graphs pass their IntSpec lists."""
        return Program.from_graph(graph, in_specs, out_specs)

    # -- client-side crypto --------------------------------------------------
    def _encrypt_one(self, generator: torch.Generator, spec, value) -> torch.Tensor:
        if isinstance(spec, IntSpec):
            spec = spec.resolve(self.params)
            vals = np.asarray(value).reshape(-1)
            assert vals.size == spec.n_ints, (
                f"spec {spec} wants {spec.n_ints} integers, got {vals.size}")
            cts = [self.int_ctx.encrypt(generator, int(v), spec.bits,
                                        spec.msg_bits).digits
                   for v in vals]
            return torch.cat(cts, dim=0)                 # (V*D, big_n+1)
        if isinstance(spec, (TensorSpec, RawSpec)):
            flat = np.asarray(value, dtype=np.int64).reshape(-1)
            return self.ctx.encrypt(generator, flat)
        raise TypeError(f"cannot encrypt for spec {spec!r}")

    def encrypt_inputs(self, generator: torch.Generator, values,
                       program: Program) -> list:
        """Encrypt one plaintext per program input, drawing from
        `generator` in input order; returns the ciphertext tensors every
        backend consumes."""
        assert len(values) == program.n_inputs, (
            f"program takes {program.n_inputs} inputs, got {len(values)}")
        return [self._encrypt_one(generator, spec, v)
                for spec, v in zip(program.in_specs, values)]

    def _decrypt_one(self, spec, arr: torch.Tensor):
        if isinstance(spec, IntSpec):
            spec = spec.resolve(self.params)
            rspec = self.int_ctx.spec(spec.bits, spec.msg_bits)
            vecs = arr.reshape(-1, rspec.n_digits, arr.shape[-1])
            ints = [self.int_ctx.decrypt(RadixCiphertext(rspec, v))
                    for v in vecs]
            if spec.shape == ():
                return ints[0]
            return np.array(ints, dtype=np.int64).reshape(spec.shape)
        return self.ctx.decrypt(arr).cpu().numpy().reshape(spec.shape)

    def decrypt_outputs(self, program: Program, outputs) -> list:
        """Decrypt backend outputs back to Python ints / numpy arrays."""
        return [self._decrypt_one(s, a)
                for s, a in zip(program.out_specs, outputs)]

    # -- execution -----------------------------------------------------------
    def run(self, program: Program, enc_inputs: list) -> list:
        """Execute on this session's backend; returns the output
        ciphertext tensors in `program.graph.outputs` order."""
        return self.backend.execute(program, enc_inputs)

    def submit(self, program: Program, enc_inputs: list,
               client_id: Optional[str] = None):
        """Async submit (serve backend): returns the request handle,
        whose `output_futures` resolve PER OUTPUT as the interpreter
        materializes them — `handle.outputs()` still joins the whole
        request.  client_id defaults to the backend's configured
        identity."""
        submit = getattr(self.backend, "submit", None)
        if submit is None:
            raise TypeError(
                f"backend {getattr(self.backend, 'name', self.backend)!r} "
                "is synchronous — use run(), or Session(backend='serve')")
        return submit(program, enc_inputs, client_id=client_id)

    def __call__(self, program: Program, generator: torch.Generator,
                 *values) -> list:
        """Convenience: encrypt -> run -> decrypt in one call."""
        enc = self.encrypt_inputs(generator, list(values), program)
        return self.decrypt_outputs(program, self.run(program, enc))

    def close(self) -> None:
        close = getattr(self.backend, "close", None)
        if close is not None:
            close()

    def __enter__(self) -> "Session":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
