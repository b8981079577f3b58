"""IR interpreter: executes compiled `repro_torch.compiler.ir` graphs on
real ciphertexts through an engine's batched PBS entry point.

The port of `repro.serve.interpreter`.  It differs from
`repro_torch.api.EagerBackend` in two ways that matter for a
multi-tenant runtime:

  * every bootstrap goes through `engine.lut_batch` — hand it a fused
    scheduler's engine proxy and all of a request's PBS rounds fuse with
    every other in-flight request's rounds;
  * a tensor-level radix node over V > 1 digit vectors FLATTENS into V
    per-vector round streams executed on concurrent worker threads, each
    registered with the shared scheduler, so the vectors of ONE request
    fuse with each other.

On a bare `TaurusEngine` the vectors run one after another on the
calling thread.  A radix node's tensor has its digit vector on the LAST
axis; each vector executes
through `IntegerContext` (`repro_torch.api.backends.eval_radix_vector`,
shared with the eager backend so the radix semantics has one
definition).
"""
from __future__ import annotations

import contextlib
import threading
from typing import Optional

import numpy as np
import torch

from repro_torch.api.backends import (eval_linear_ct_op, eval_radix_vector,
                                      split_radix_operands)
from repro_torch.compiler.ir import Graph, RADIX_OPS
from repro_torch.core import glwe
from repro_torch.core.engine import TaurusEngine
from repro_torch.core.integer import IntegerContext


class IrInterpreter:
    """Runs a compiled Graph on real ciphertexts via `engine.lut_batch`.

    `engine` is a TaurusEngine (default: one on the keys' device) or a
    `FusedEngineProxy`; with a proxy, per-round padding is left to the
    fused scheduler (padding tiny per-request rounds would only dilute
    the fused batch).  `pad_rounds` overrides that default.

    intra_fuse: with a fused engine, execute the V vectors of one
    tensor-level radix node on V concurrent threads (each holding its
    own scheduler registration) so their identical round schedules
    barrier into shared batches.

    holds_slot: True when the calling thread itself holds a scheduler
    registration (a serving worker) — the vector fan-out then parks that
    slot while it joins, so the barrier never waits on a thread that is
    not computing rounds.

    request: the serving request's id, carried by the fan-out threads'
    `radix_vectors` spans (with a `telemetry`).  `rounds` and `pbs`
    count the PBS rounds this interpreter submitted and their logical
    rows (before any padding), over every run.

    Example (the in-process serving contract, no queue)::

        interp = IrInterpreter(ctx, engine)
        outs = interp.run_outputs(program.graph, enc_inputs)
    """

    def __init__(self, ctx, engine=None, *,
                 pad_rounds: Optional[bool] = None,
                 intra_fuse: bool = True,
                 holds_slot: bool = False,
                 telemetry=None,
                 request: Optional[int] = None):
        self.ctx = ctx
        self.engine = engine if engine is not None \
            else TaurusEngine.from_context(ctx, device=ctx.device)
        self.params = ctx.params
        if pad_rounds is None:
            pad_rounds = not getattr(self.engine, "fused", False)
        self.telemetry = telemetry
        self.int_ctx = IntegerContext(ctx, self.engine, pad_batches=pad_rounds,
                                      telemetry=telemetry)
        self.intra_fuse = intra_fuse
        self.holds_slot = holds_slot
        self.request = request
        self._poly_cache: dict = {}
        # the `lut` nodes' rounds and rows (radix rounds: int_ctx.stats)
        self._lut_rounds = 0
        self._lut_rows = 0

    @property
    def rounds(self) -> int:
        return self.int_ctx.stats["lut_batches"] + self._lut_rounds

    @property
    def pbs(self) -> int:
        return self.int_ctx.stats["pbs"] + self._lut_rows

    # -- helpers -------------------------------------------------------------
    def _lut_poly(self, table: np.ndarray) -> torch.Tensor:
        key = np.ascontiguousarray(table).tobytes()
        if key not in self._poly_cache:
            self._poly_cache[key] = glwe.make_lut_polys_cached(
                np.asarray(table)[None], self.params,
                device=getattr(self.engine, "device", None))[0]
        return self._poly_cache[key]

    # upper bound on fan-out threads per radix node: beyond this, each
    # worker takes a contiguous slice of vectors sequentially (rounds
    # still fuse MAX_FANOUT wide; unbounded V-wide threading would risk
    # thread exhaustion and stack churn on large tensors)
    MAX_FANOUT = 32

    def _radix_fanout(self, n, spec, a: torch.Tensor,
                      b: Optional[torch.Tensor], sched,
                      max_val: Optional[int] = None) -> list:
        """Per-vector rounds on concurrent threads sharing `sched`: the
        scheduler barrier fuses them like independent requests.

        With `holds_slot`, the last worker to finish hands its slot back
        to the request thread instead of releasing it (the reference
        releases it and the request thread registers again after the
        join).  In between, the barrier would count one slot fewer for
        this request, and a round of the other requests could dispatch
        without this request's next round, depending on which thread
        runs first; with the hand-off the fused rounds do not depend on
        thread timing."""
        V = int(a.shape[0])
        outs: list = [None] * V
        errors: list = []
        nt = min(V, self.MAX_FANOUT)
        slices = [range(w, V, nt) for w in range(nt)]
        handoff = {"left": nt, "kept": False}
        lock = threading.Lock()

        tel = self.telemetry

        def work(idx) -> None:
            try:
                with (tel.span("radix_vectors", cat="serve",
                               request=self.request, vectors=len(idx))
                      if tel is not None else contextlib.nullcontext()):
                    for v in idx:
                        outs[v] = eval_radix_vector(
                            self.int_ctx, n.op, spec, a[v],
                            None if b is None else b[v], max_val=max_val)
            except BaseException as err:  # noqa: BLE001 — re-raised below
                errors.append(err)
            finally:
                with lock:
                    handoff["left"] -= 1
                    keep = self.holds_slot and handoff["left"] == 0
                    handoff["kept"] = keep
                if not keep:
                    sched.unregister()

        threads = [threading.Thread(target=work, args=(idx,), daemon=True)
                   for idx in slices]
        # register every worker BEFORE any starts so the barrier width is
        # right from the first round; a started thread owns its slot (the
        # finally above releases it), slots of never-started threads are
        # released here so a start() failure can't inflate the barrier
        # forever
        for _ in threads:
            sched.register()
        started = 0
        try:
            for t in threads:
                t.start()
                started += 1
        finally:
            with lock:
                handoff["left"] -= len(threads) - started
            for _ in range(len(threads) - started):
                sched.unregister()
            # park the request's own slot while joining (this thread
            # computes no rounds meanwhile)
            if self.holds_slot:
                sched.unregister()
            try:
                for t in threads[:started]:
                    t.join()
            finally:
                if self.holds_slot and not handoff["kept"]:
                    sched.register()
        if errors:
            raise errors[0]
        return outs

    def _radix(self, n, vals) -> torch.Tensor:
        # a radix_linear node's LPU combine and carry-save compression run
        # on the request thread (inside `split_radix_operands`); only the
        # final per-vector propagation fans out below
        ic = self.int_ctx
        spec, a, b, mv = split_radix_operands(ic, n, vals)
        sched = getattr(self.engine, "_scheduler", None)
        if self.intra_fuse and sched is not None and a.shape[0] > 1:
            outs = self._radix_fanout(n, spec, a, b, sched, max_val=mv)
        else:
            outs = [eval_radix_vector(ic, n.op, spec, a[v],
                                      None if b is None else b[v],
                                      max_val=mv)
                    for v in range(a.shape[0])]
        return torch.cat(outs, dim=0)

    # -- run ------------------------------------------------------------------
    def run(self, g: Graph, enc_inputs: list, on_node=None) -> dict:
        """enc_inputs: one (n_elements, k*N+1) ciphertext tensor per input
        node.  Returns {node_id: ciphertext tensor} for every node.

        on_node: optional callback `on_node(node_id, value)` fired the
        moment each node's value materializes."""
        vals: dict = {}
        it = iter(enc_inputs)
        for n in g.nodes:
            if n.op == "input":
                vals[n.id] = next(it)
            else:
                out = eval_linear_ct_op(n, vals, self.params)
                if out is not None:
                    vals[n.id] = out
                elif n.op == "lut":
                    cts = vals[n.inputs[0]]
                    poly = self._lut_poly(n.attrs["table"])
                    polys = poly.expand((cts.shape[0],) + tuple(poly.shape))
                    vals[n.id] = self.engine.lut_batch(cts, polys)
                    self._lut_rounds += 1
                    self._lut_rows += int(cts.shape[0])
                elif n.op in RADIX_OPS:
                    vals[n.id] = self._radix(n, vals)
                else:
                    raise ValueError(n.op)
            if on_node is not None:
                on_node(n.id, vals[n.id])
        return vals

    def run_outputs(self, g: Graph, enc_inputs: list) -> list:
        """Like `run`, but returns just the graph outputs, in order."""
        vals = self.run(g, enc_inputs)
        return [vals[i] for i in g.outputs]
