"""Pluggable execution backends behind the `Session` front door.

The port of `repro.api.backends`.  One protocol —
`Backend.execute(program, enc_inputs) -> outputs` — and three
implementations:

  EagerBackend   direct execution for debugging: `lut` nodes run the
                 KS-first PBS with the paper's KS/ACC dedup live, radix
                 nodes run straight through `IntegerContext`.
  LocalBackend   the serving execution contract in-process:
                 `repro_torch.serve.IrInterpreter`, every bootstrap
                 through `engine.lut_batch` (with `fused=True`, through
                 a private `FusedLutScheduler`).
  ServeBackend   submits through a `repro_torch.serve.ServeRuntime`:
                 cross-request fused rounds, online dedup, admission
                 control, fault retry.

All run every bootstrap through the session's `TaurusEngine`, so with
`kernel_backend="fused"` every PBS round on the card runs the port's
kernels.  (The reference's eager `lut` path calls its plain batch
functions; the port's goes through `engine.keyswitch` and
`engine.lut_batch_small`, the same KS-first split, bit-identical in the
keyswitch and decrypt-identical after it.)
"""
from __future__ import annotations

from typing import Optional, Protocol, runtime_checkable

import numpy as np
import torch

from repro_torch.compiler.ir import RADIX_OPS
from repro_torch.core import glwe, lwe, torus
from repro_torch.core.engine import TaurusEngine
from repro_torch.core.integer import IntegerContext, RadixCiphertext
from repro_torch.core.params import TFHEParams

@runtime_checkable
class Backend(Protocol):
    """The execution contract every backend implements."""
    name: str

    def execute(self, program, enc_inputs: list) -> list:
        """Run `program.graph` on encrypted inputs; returns the output
        ciphertext tensors in `program.graph.outputs` order."""
        ...


def _engine_for(ctx, engine=None, kernel_backend=None) -> TaurusEngine:
    """`engine`, or a new one on the keys' device."""
    if engine is not None:
        return engine
    kw = {} if kernel_backend is None else {"kernel_backend": kernel_backend}
    return TaurusEngine.from_context(ctx, device=ctx.device, **kw)


def _encode(values, p: TFHEParams, device) -> torch.Tensor:
    """Integer plaintexts (taken mod 2^width) -> torus int64."""
    vals = np.asarray(values, np.int64).reshape(-1) % (1 << p.width)
    return torus.encode(vals, p.delta, device=device)


# ---------------------------------------------------------------------------
# shared node evaluators
# ---------------------------------------------------------------------------

def eval_linear_ct_op(n, vals: dict, p: TFHEParams):
    """Evaluate one PBS-free IR node on ciphertext tensors (LPU work:
    add/sub/addc/mulc/linear/reshape/concat and the radix const ops).
    Returns the result tensor, or None if `n` is not a linear op.  Shared
    by `EagerBackend` and `IrInterpreter` so their linear semantics
    cannot diverge.  Every product and sum wraps mod 2^64 in int64."""
    if n.op == "add":
        return lwe.add(vals[n.inputs[0]], vals[n.inputs[1]])
    if n.op == "sub":
        return lwe.sub(vals[n.inputs[0]], vals[n.inputs[1]])
    if n.op == "addc":
        x = vals[n.inputs[0]]
        c = torch.broadcast_to(_encode(n.attrs["const"], p, x.device), x.shape[:-1])
        out = x.clone()
        out[..., -1] += c
        return out
    if n.op == "mulc":
        c = torch.as_tensor(np.asarray(n.attrs["const"], np.int64).reshape(-1))
        x = vals[n.inputs[0]]
        return x * c.to(x.device)[:, None]
    if n.op == "linear":
        W = torch.as_tensor(np.asarray(n.attrs["W"], np.int64))
        x = vals[n.inputs[0]]                      # (in, big_n+1)
        y = lwe.wrapping_matmul(W.T.contiguous().to(x.device), x)
        if n.attrs.get("bias") is not None:
            y[..., -1] += _encode(n.attrs["bias"], p, x.device)
        return y
    if n.op == "radix_addc":
        # digitize the constant and add each digit onto the matching
        # digit ciphertext's body — LPU only, result left un-propagated
        # (its digit ceiling rides on the node's max_val attr)
        m, d = n.attrs["msg_bits"], n.attrs["n_digits"]
        c = int(n.attrs["const"]) % (1 << (m * d))
        digs = np.array([(c >> (i * m)) & ((1 << m) - 1) for i in range(d)],
                        dtype=np.int64)
        x = vals[n.inputs[0]]                      # (V*d, big_n+1)
        out = x.clone()
        out[..., -1] += torus.encode(np.tile(digs, x.shape[0] // d), p.delta,
                                     device=x.device)
        return out
    if n.op == "radix_mulc":
        return lwe.scalar_mul(vals[n.inputs[0]], int(n.attrs["const"]))
    if n.op in ("reshape", "concat"):
        return vals[n.inputs[0]]
    return None


def eval_radix_vector(ic: IntegerContext, op: str, spec, av: torch.Tensor,
                      bv: Optional[torch.Tensor],
                      max_val: Optional[int] = None) -> torch.Tensor:
    """One radix IR op on ONE digit vector through `IntegerContext`.
    Shared by `EagerBackend` and `IrInterpreter` — the radix execution
    semantics has exactly one definition.

    For `radix_linear`, `av` is one PRE-COMBINED output vector from
    `IntegerContext.linear_compress` and `max_val` its digit ceiling;
    this evaluator finishes the carry propagation."""
    ra = RadixCiphertext(spec, av)
    if op in ("radix_linear", "radix_norm"):
        return ic.propagate(ra, max_val=max_val).digits
    if op == "radix_add":
        return ic.add(ra, RadixCiphertext(spec, bv)).digits
    if op == "radix_sub":
        return ic.sub(ra, RadixCiphertext(spec, bv)).digits
    if op == "radix_mul":
        return ic.mul(ra, RadixCiphertext(spec, bv)).digits
    if op == "radix_relu":
        return ic.relu_clamp(ra).digits
    if op == "radix_cmp":
        return ic.compare(ra, RadixCiphertext(spec, bv))[None]
    raise ValueError(op)


def split_radix_operands(ic: IntegerContext, n, vals: dict):
    """The operands of radix node `n` as per-vector digit tensors:
    (spec, a (V, D, k*N+1), b or None, max_val or None).  A
    `radix_linear` node is LPU-combined and carry-save compressed here to
    one vector per output column; the per-vector evaluation finishes its
    propagation."""
    m, d = n.attrs["msg_bits"], n.attrs["n_digits"]
    spec = ic.spec(m * d, m)
    width = ic.params.big_n + 1
    a = vals[n.inputs[0]].reshape(-1, d, width)
    b, mv = None, None
    if n.op == "radix_linear":
        a, mv = ic.linear_compress(a, n.attrs["W"], spec)
    elif n.op == "radix_norm":
        mv = n.attrs["max_val"]
    elif len(n.inputs) == 2:
        b = vals[n.inputs[1]].reshape(-1, d, width)
    return spec, a, b, mv


# ---------------------------------------------------------------------------
# eager
# ---------------------------------------------------------------------------

class EagerBackend:
    """Direct execution for debugging: no queue, no round scheduler.

    `lut` nodes run the KS-first PBS pipeline with both paper dedups
    live (KS results cached per source tensor, one accumulator image per
    unique table); `radix_*` nodes dispatch per digit vector through a
    private `IntegerContext`.  Counts what it does in `stats`.
    """

    name = "eager"

    def __init__(self, ctx, engine=None, *, ks_dedup: bool = True,
                 acc_dedup: bool = True, telemetry=None):
        self.ctx = ctx
        self.params: TFHEParams = ctx.params
        self.ks_dedup = ks_dedup
        self.acc_dedup = acc_dedup
        self.telemetry = telemetry
        self.int_ctx = IntegerContext.create(
            ctx, _engine_for(ctx, engine), telemetry=telemetry)
        self.stats = {"pbs": 0, "keyswitch": 0, "lut_polys": 0}
        self._lut_cache: dict = {}

    @property
    def engine(self) -> TaurusEngine:
        return self.int_ctx.engine

    # -- the KS-first PBS pipeline (per unique-table accumulator) -----------
    def _lut_poly(self, table: np.ndarray) -> torch.Tensor:
        key = table.tobytes() if self.acc_dedup else object()
        if key not in self._lut_cache:
            self._lut_cache[key] = glwe.make_lut_poly(
                table.astype(np.int64), self.params, device=self.engine.device)
            self.stats["lut_polys"] += 1
        return self._lut_cache[key]

    def _pbs(self, cts, table, small_cache_key, ks_cache):
        """PBS with the KS-first order so key-switch results are reusable."""
        if self.ks_dedup and small_cache_key in ks_cache:
            small = ks_cache[small_cache_key]
        else:
            small = self.engine.keyswitch(cts)
            self.stats["keyswitch"] += int(cts.shape[0])
            ks_cache[small_cache_key] = small
        poly = self._lut_poly(table)
        out = self.engine.lut_batch_small(
            small, poly.expand(cts.shape[0], self.params.N))
        self.stats["pbs"] += int(cts.shape[0])
        return out

    def _radix(self, n, vals: dict) -> torch.Tensor:
        spec, a, b, mv = split_radix_operands(self.int_ctx, n, vals)
        outs = [eval_radix_vector(self.int_ctx, n.op, spec, a[v],
                                  None if b is None else b[v], max_val=mv)
                for v in range(a.shape[0])]
        return torch.cat(outs, dim=0)

    # -- run -----------------------------------------------------------------
    def run(self, g, enc_inputs: list) -> dict:
        """Execute a Graph; returns {node_id: ciphertext tensor} for every
        node."""
        vals: dict = {}
        ks_cache: dict = {}
        it = iter(enc_inputs)
        for n in g.nodes:
            if n.op == "input":
                vals[n.id] = next(it)
                continue
            out = eval_linear_ct_op(n, vals, self.params)
            if out is not None:
                vals[n.id] = out
            elif n.op == "lut":
                vals[n.id] = self._pbs(vals[n.inputs[0]],
                                       np.asarray(n.attrs["table"]),
                                       n.inputs[0], ks_cache)
            elif n.op in RADIX_OPS:
                vals[n.id] = self._radix(n, vals)
            else:
                raise ValueError(n.op)
        return vals

    def execute(self, program, enc_inputs: list) -> list:
        vals = self.run(program.graph, enc_inputs)
        return [vals[o] for o in program.graph.outputs]


# ---------------------------------------------------------------------------
# local (serving interpreter in-process)
# ---------------------------------------------------------------------------

class LocalBackend:
    """The serving execution contract without the queue: a
    `repro_torch.serve.IrInterpreter` over this process's engine.  With
    `fused=True` the engine is wrapped in a private `FusedLutScheduler`,
    so the per-vector rounds of one program's tensor-level radix nodes
    fuse into shared batches (intra-request fusion, no runtime needed).
    """

    name = "local"

    def __init__(self, ctx, engine=None, *, fused: bool = False,
                 telemetry=None):
        from repro_torch.serve.interpreter import IrInterpreter
        from repro_torch.serve.scheduler import FusedLutScheduler
        engine = _engine_for(ctx, engine)
        self.telemetry = telemetry
        self.scheduler = (FusedLutScheduler(telemetry=telemetry)
                          if fused else None)
        eng = self.scheduler.proxy(engine) if fused else engine
        self.interp = IrInterpreter(ctx, eng, telemetry=telemetry)

    def execute(self, program, enc_inputs: list) -> list:
        return self.interp.run_outputs(program.graph, enc_inputs)


# ---------------------------------------------------------------------------
# serve (multi-tenant runtime)
# ---------------------------------------------------------------------------

class ServeBackend:
    """Submits programs through a `ServeRuntime`: the session's traffic
    joins cross-request fused PBS rounds and online dedup, and a traced
    program's tensor-level radix nodes flatten into per-vector rounds
    that fuse intra-request (`IrInterpreter` vector fan-out).

    Runtime keywords thread straight through — `Session(ctx,
    backend="serve", shards=2, elastic=True, max_inflight=8)` builds a
    sharded runtime exactly like calling `ServeRuntime` directly."""

    name = "serve"

    def __init__(self, ctx, engine=None, *, runtime=None,
                 client_id: str = "session", **runtime_kw):
        from repro_torch.serve.runtime import ServeRuntime
        self._owns_runtime = runtime is None
        self.runtime = runtime if runtime is not None \
            else ServeRuntime(ctx, engine, **runtime_kw)
        # the runtime's Telemetry (passed via runtime_kw or its default):
        # `Session.telemetry` and `metrics()` read through this
        self.telemetry = self.runtime.telemetry
        self.client_id = client_id

    def metrics(self) -> dict:
        return self.runtime.metrics()

    @property
    def scheduler(self):
        return self.runtime.scheduler

    def submit(self, program, enc_inputs: list,
               client_id: Optional[str] = None):
        """Async path: returns the runtime's `RequestHandle`
        (`handle.outputs()` joins)."""
        return self.runtime.submit(program.graph, enc_inputs,
                                   client_id=client_id or self.client_id)

    def execute(self, program, enc_inputs: list) -> list:
        return self.submit(program, enc_inputs).outputs()

    def close(self) -> None:
        if self._owns_runtime:
            self.runtime.close()


_BACKENDS = {"eager": EagerBackend, "local": LocalBackend,
             "serve": ServeBackend}


def make_backend(name: str, ctx, engine=None, *, kernel_backend=None, **kw):
    """Construct a named backend ("eager" | "local" | "serve") over the
    given key material; extra keywords forward to the backend's
    constructor (e.g. `fused=True` for local, `max_inflight=8` or
    `shards=2` for serve).  `kernel_backend="fused" | "reference"`
    selects the engine room when no prebuilt engine is passed (see
    `repro_torch.core.engine`).  Use it directly to share one backend
    across sessions::

        be = make_backend("serve", ctx, engine, max_inflight=4)
        sess = Session(ctx, engine, backend=be)
    """
    try:
        cls = _BACKENDS[name]
    except KeyError:
        raise ValueError(f"unknown backend {name!r} "
                         f"(have {sorted(_BACKENDS)})") from None
    if kernel_backend is not None and engine is not None:
        raise TypeError("pass kernel_backend OR a prebuilt engine, not both")
    if kernel_backend is not None:
        engine = _engine_for(ctx, kernel_backend=kernel_backend)
    return cls(ctx, engine, **kw)
