"""Multi-tenant serving runtime: a front-door ROUTER over N engine
shards — request queue, admission control, per-client fairness, request
placement, fault retry.  The port of `repro.serve.runtime`.

`ServeRuntime.submit(graph, enc_inputs, client_id)` returns a
`RequestHandle` immediately (async queue semantics — `handle.wait()`
joins the result).  Admission pulls queued requests round-robin across
clients, so one client flooding the queue cannot starve another: a
request is admitted within (#clients x its position in its own client's
queue + #clients) admissions.

Execution is SHARDED: the router places each admitted request on an
`EngineShard` (`repro_torch.serve.shard`) — parameter-set filter, then
least-loaded, then lowest index — and each shard runs its own engine,
fusion barrier and concurrency limit.  At most `max_inflight` requests
execute concurrently PER SHARD (each on a worker thread whose PBS rounds
fuse through the shard's `FusedLutScheduler`); with `elastic=True` the
per-shard limit is a live `ElasticAdmission` grant driven by queue depth
and recent fused-wave occupancy, with `max_inflight` as the hard
ceiling.  Each client's backlog is capped at `max_queued_per_client` —
beyond it `submit` raises `AdmissionError` (shed load at the door, not
mid-round).  `shards=1` (the default) is the single-shard case.

Failures retry through `repro_torch.runtime.fault.StepRunner`: a request
whose execution raises (a poisoned round, a device fault) is re-run from
its encrypted inputs up to `fault.max_retries` times; a failed fused
round fans its error out to every participating request, and each
retries independently.
"""
from __future__ import annotations

import collections
import dataclasses
import threading
import time
from typing import Callable, Optional

from repro_torch.compiler.ir import Graph
from repro_torch.core.engine import TaurusEngine
from repro_torch.obs import StatsView, Telemetry
from repro_torch.runtime.fault import FaultConfig, StepRunner
from repro_torch.serve.interpreter import IrInterpreter
from repro_torch.serve.shard import EngineShard, build_shards


class AdmissionError(RuntimeError):
    """A client's queue is full — the request was not accepted."""


class SubmitValidationError(ValueError):
    """The request is malformed (input count/shape vs the graph's input
    nodes) — rejected at submit, before any worker thread runs.  Without
    this check a bad request would only fail DEEP in execution, and the
    fault layer would burn `max_retries` re-runs on a request that can
    never succeed."""


class RuntimeClosedError(RuntimeError):
    """submit() after close() — the runtime no longer admits work.  Also
    the terminal error of requests still queued when `close(drain=False)`
    shuts the runtime down: their waiters unblock immediately instead of
    hanging on a handle nobody will ever execute."""


class RequestAbandonedError(RuntimeError):
    """The request was canceled while still queued (`ServeRuntime.cancel`
    / `RequestHandle.abandon`) — e.g. a client's deadline expired before
    admission.  Waiters see this instead of blocking forever."""


@dataclasses.dataclass
class ServeRequest:
    """One queued unit of work: a compiled IR graph plus the client's
    encrypted inputs (one big-key LWE tensor per graph input node).  The
    runtime assigns `request_id` at submit."""
    client_id: str
    graph: Graph
    enc_inputs: list
    request_id: int = -1


class OutputFuture:
    """Completion handle for ONE graph output of one request.

    Resolves the moment the interpreter materializes its node — possibly
    rounds before the whole request finishes — with a `completed_at`
    timestamp (perf_counter timebase) that feeds the request's trace
    span.  Early resolution is sound because graph execution is
    deterministic over immutable encrypted inputs: an output computed
    before a later step fails is still the output, and a fault-layer
    retry skips already-resolved futures.  Only outputs still unresolved
    when the request exhausts its retries `fail()`."""

    __slots__ = ("node_id", "index", "value", "error", "completed_at",
                 "_done")

    def __init__(self, node_id: int, index: int):
        self.node_id = node_id
        self.index = index                 # position in graph.outputs
        self.value = None
        self.error: Optional[BaseException] = None
        self.completed_at: Optional[float] = None
        self._done = threading.Event()

    def done(self) -> bool:
        return self._done.is_set()

    def wait(self, timeout: Optional[float] = None):
        """Block until this output is ready; returns its ciphertext tensor."""
        if not self._done.wait(timeout):
            raise TimeoutError(f"output {self.index} (node {self.node_id}) "
                               f"not ready")
        if self.error is not None:
            raise self.error
        return self.value

    def resolve(self, value, ts: float) -> bool:
        """First resolution wins (retries re-visit nodes); returns whether
        this call was the one that resolved it."""
        if self._done.is_set():
            return False
        self.value = value
        self.completed_at = ts
        self._done.set()
        return True

    def fail(self, err: BaseException) -> None:
        if not self._done.is_set():
            self.error = err
            self._done.set()


class RequestHandle:
    """Async result handle for one submitted request.

    Example::

        h = runtime.submit(graph, enc_inputs, client_id="alice")
        while not h.done():
            ...                       # overlap client-side work
        cts = h.outputs()             # graph outputs, in order

    `wait()` re-raises the request's terminal error (after the fault
    layer exhausted its retries); `retries` counts the re-runs.

    `output_futures` holds one `OutputFuture` per graph output (in
    output order): each resolves as soon as its node is computed, so a
    client can stream early outputs while later ones still execute."""

    def __init__(self, request: ServeRequest):
        self.request = request
        self.result: Optional[dict] = None
        self.error: Optional[BaseException] = None
        self.retries = 0
        self.submitted_at: Optional[float] = None   # perf_counter stamps
        self.admitted_at: Optional[float] = None
        self.completed_at: Optional[float] = None
        self._runtime = None                        # set by submit()
        self._done = threading.Event()
        self.output_futures = [
            OutputFuture(nid, i)
            for i, nid in enumerate(request.graph.outputs)]
        # node id -> futures (a node may be listed as an output twice)
        self._out_map: dict = {}
        for f in self.output_futures:
            self._out_map.setdefault(f.node_id, []).append(f)

    def done(self) -> bool:
        return self._done.is_set()

    def wait(self, timeout: Optional[float] = None) -> dict:
        """Block until executed; returns {node_id: ciphertext tensor}."""
        if not self._done.wait(timeout):
            raise TimeoutError(
                f"request {self.request.request_id} still queued/running")
        if self.error is not None:
            raise self.error
        return self.result

    def outputs(self) -> list:
        """Graph outputs of the finished request, in order."""
        vals = self.wait()
        return [vals[i] for i in self.request.graph.outputs]

    def abandon(self) -> bool:
        """Cancel this request if it is still queued (deadline expired,
        client gave up).  True if it was removed before admission — the
        handle then terminates with `RequestAbandonedError`.  False if
        already executing or done: an in-flight request cannot be
        stopped mid-round, so the caller decides whether to keep
        waiting."""
        rt = self._runtime
        return rt.cancel(self) if rt is not None else False


class ServeRuntime:
    """The multi-tenant FHE serving front door: router + engine shards.

    Args (all keyword-only beyond ctx/engine):
      ctx        TFHEContext whose evaluation keys execute the traffic.
      engine     TaurusEngine shard 0 dispatches batched PBS on
                 (defaults to a fresh engine on the keys' device); shards
                 beyond the first always build their own engine from ctx
                 with the same kernel backend (over the key's one
                 resident pack).
      kernel_backend  "fused" | "reference" engine room for the shard
                 engines (see `repro_torch.core.engine`); invalid
                 alongside a prebuilt engine.  Fused waves inherit it
                 because the scheduler proxy dispatches through
                 `engine.lut_batch`.
      shards     number of engine shards.  The router places each
                 admitted request on the least-loaded shard that accepts
                 its parameter set; `shards=1` (default) is the
                 single-shard special case.
      elastic    None/False: static per-shard limit (`max_inflight`).
                 True: per-shard `ElasticAdmission` controllers
                 (`repro_torch.runtime.elastic`) grow the limit under backlog
                 (occupancy permitting) and shrink it when idle, with
                 `max_inflight` as the hard ceiling.  Or pass an
                 `ElasticPolicy` for explicit knobs.
      shard_devices  one device tuple per shard (defaults to
                 `launch.mesh.shard_devices(shards, [ctx.device])`: every
                 shard on the keys' device); a multi-device shard runs a
                 one-device engine on its first device.
      fused      barrier concurrent requests' PBS rounds into shared
                 `lut_batch` dispatches via each shard's
                 `FusedLutScheduler`.
      dedup      online (ciphertext, table) row dedup inside fused rounds.
      ks_dedup   KS-level partial dedup: fused rows sharing a ciphertext
                 but not a table key-switch once (`ks_dedup_hits`).
      max_inflight            concurrent worker threads PER SHARD (the
                              elastic ceiling when `elastic` is set).
      max_queued_per_client   backlog cap per client; beyond it `submit`
                              raises `AdmissionError`.
      fault / fault_hook      retry policy (`runtime.fault.FaultConfig`)
                              and a chaos hook called per attempt.
      start_paused            queue without executing until `resume()`.
      intra_fuse              fan one request's tensor-level radix nodes
                              out per vector so they fuse intra-request.
      telemetry               a `repro_torch.obs.Telemetry`; defaults to a
                              private metrics-only one (tracing off).
                              `metrics()` returns its snapshot.

    Example::

        rt = ServeRuntime(ctx, shards=2, max_inflight=8)
        h = rt.submit(graph, enc_inputs, client_id="alice")
        outputs = h.outputs()        # blocks; ciphertext tensors
        rt.close()

    Most callers go through `repro_torch.api.Session(ctx, backend="serve")`,
    which wraps submit/wait behind the portable Program contract (the
    `shards=` knob threads through it like `max_inflight` does).
    """

    def __init__(self, ctx, engine: Optional[TaurusEngine] = None, *,
                 fused: bool = True, dedup: bool = True,
                 ks_dedup: bool = True,
                 shards: int = 1,
                 elastic=None,
                 shard_devices: Optional[list] = None,
                 max_inflight: int = 8,
                 max_queued_per_client: Optional[int] = None,
                 fault: Optional[FaultConfig] = None,
                 fault_hook: Optional[Callable] = None,
                 start_paused: bool = False,
                 intra_fuse: bool = True,
                 kernel_backend: Optional[str] = None,
                 telemetry: Optional[Telemetry] = None):
        self.ctx = ctx
        if kernel_backend is not None and engine is not None:
            raise TypeError("pass kernel_backend OR a prebuilt engine, "
                            "not both")
        self.fused = fused
        self.telemetry = telemetry if telemetry is not None else Telemetry()
        self.fault = fault if fault is not None else FaultConfig(max_retries=2)
        # fuse the per-vector rounds of one request's tensor-level radix
        # nodes through the shared scheduler (IrInterpreter fan-out)
        self.intra_fuse = intra_fuse
        # test/chaos hook: called as fault_hook(request, attempt) at the
        # start of every execution attempt; raising simulates a failure
        self.fault_hook = fault_hook
        # per-shard limit (elastic ceiling when elastic is enabled)
        self.max_inflight = max_inflight
        self.max_queued_per_client = max_queued_per_client
        self.n_shards = shards
        self.shards = build_shards(
            ctx, engine, n_shards=shards, fused=fused, dedup=dedup,
            ks_dedup=ks_dedup, max_inflight=max_inflight, elastic=elastic,
            kernel_backend=kernel_backend, telemetry=self.telemetry,
            device_sets=shard_devices)
        self._lock = threading.Lock()
        self._queues: dict = {}                  # client -> deque[handle]
        self._client_ring: list = []             # round-robin order
        self._rr = 0
        self._next_id = 0
        self._paused = start_paused
        self._closed = False
        self._threads: list = []
        tel = self.telemetry
        self._c = {k: tel.counter(f"serve.{k}")
                   for k in ("admitted", "completed", "failed",
                             "retries", "rejected", "invalid",
                             "abandoned")}
        self._h_latency = tel.histogram("serve.request_latency_s")
        self._h_queue_wait = tel.histogram("serve.queue_wait_s")
        self._h_queue_depth = tel.histogram("serve.queue_depth")
        self._g_queue_depth = tel.gauge("serve.queue_depth")
        # "admitted" is an observability log (fairness tests/monitoring),
        # bounded so a long-lived server doesn't grow per-request state
        self._admitted_log: collections.deque = collections.deque(
            maxlen=10_000)

    # -- single-shard back-compat surface ------------------------------------
    @property
    def engine(self) -> TaurusEngine:
        """Shard 0's engine — THE engine of a `shards=1` runtime (the
        object the caller passed in), the first shard's otherwise."""
        return self.shards[0].engine

    @property
    def scheduler(self):
        """Shard 0's `FusedLutScheduler` (None when `fused=False`) —
        THE scheduler of a `shards=1` runtime.  Multi-shard callers read
        each shard's own `rt.shards[i].scheduler`."""
        return self.shards[0].scheduler

    @property
    def stats(self) -> StatsView:
        """Stats mapping (`admitted` deque log; `completed`/`failed`/
        `retries`/`rejected`/`invalid`/`abandoned` counts), read live off
        the metrics registry."""
        sources: dict = dict(self._c)
        sources["admitted"] = self._admitted_log
        return StatsView(sources)

    def metrics(self) -> dict:
        """The full telemetry snapshot: serve.*, sched.*, integer.*
        counters/gauges/histograms plus the bandwidth ledger."""
        return self.telemetry.snapshot()

    # -- client API ----------------------------------------------------------
    def _validate_submit(self, graph: Graph, enc_inputs: list) -> None:
        """Typed, submit-time request validation: mismatches raise
        `SubmitValidationError` at the door instead of surfacing as
        worker-thread failures that the fault layer retries."""
        in_nodes = [n for n in graph.nodes if n.op == "input"]
        if len(enc_inputs) != len(in_nodes):
            self._c["invalid"].inc()
            raise SubmitValidationError(
                f"graph has {len(in_nodes)} input nodes but "
                f"{len(enc_inputs)} encrypted inputs were submitted")
        ct_width = self.ctx.params.big_n + 1
        for node, arr in zip(in_nodes, enc_inputs):
            shape = tuple(getattr(arr, "shape", ()))
            if len(shape) != 2 or shape != (node.n_elements, ct_width):
                self._c["invalid"].inc()
                raise SubmitValidationError(
                    f"input for node {node.id} (shape {node.shape}): "
                    f"expected a ({node.n_elements}, {ct_width}) big-key "
                    f"LWE tensor, got {shape or type(arr).__name__}")

    def submit(self, graph: Graph, enc_inputs: list,
               client_id: str = "client-0") -> RequestHandle:
        """Queue one request; returns its `RequestHandle` immediately.

        enc_inputs: one (n_elements, k*N+1) big-key LWE tensor per graph
        input node (shape-checked at the door; mismatches raise
        `SubmitValidationError`, a full client queue `AdmissionError`,
        a closed runtime `RuntimeClosedError`).  The request executes on
        a worker thread as soon as admission (round-robin across
        clients, at most `max_inflight` in flight) picks it."""
        with self._lock:
            if self._closed:
                raise RuntimeClosedError(
                    "runtime is closed — create a new ServeRuntime")
            self._validate_submit(graph, enc_inputs)
            queued = len(self._queues.get(client_id, ()))
            if (self.max_queued_per_client is not None
                    and queued >= self.max_queued_per_client):
                self._c["rejected"].inc()
                raise AdmissionError(
                    f"client {client_id!r} already has {queued} queued "
                    f"requests (cap {self.max_queued_per_client})")
            q = self._queues.setdefault(client_id, collections.deque())
            req = ServeRequest(client_id, graph, enc_inputs, self._next_id)
            self._next_id += 1
            handle = RequestHandle(req)
            handle._runtime = self
            handle.submitted_at = time.perf_counter()
            q.append(handle)
            if client_id not in self._client_ring:
                self._client_ring.append(client_id)
            self.telemetry.instant("submit", cat="serve",
                                   request=req.request_id, client=client_id)
            depth = sum(len(qq) for qq in self._queues.values())
            self._g_queue_depth.set(depth)
            self._h_queue_depth.observe(depth)
            self._admit_locked()
        return handle

    def pause(self) -> None:
        """Stop admitting (in-flight requests finish); queue keeps filling."""
        with self._lock:
            self._paused = True

    def resume(self) -> None:
        """Start (or restart) admitting queued requests."""
        with self._lock:
            self._paused = False
            self._admit_locked()

    def drain(self) -> None:
        """Block until every queued/in-flight request has completed."""
        while True:
            with self._lock:
                queued = sum(len(q) for q in self._queues.values())
                busy = sum(s.inflight for s in self.shards)
                if queued and not busy and self._paused:
                    raise RuntimeError(
                        "drain() on a paused runtime with queued requests "
                        "— call resume() first")
            if not queued and not busy:
                return
            for t in list(self._threads):
                t.join(timeout=0.05)

    def cancel(self, handle: RequestHandle) -> bool:
        """Remove a still-queued request; True if it was canceled.

        A canceled handle terminates immediately with
        `RequestAbandonedError` (its waiters and output futures all
        unblock).  Returns False when the request was already admitted
        or finished — an executing request cannot be stopped mid-round."""
        req = handle.request
        with self._lock:
            q = self._queues.get(req.client_id)
            if q is None or handle not in q:
                return False
            q.remove(handle)
            if not q:
                del self._queues[req.client_id]
                ring = self._client_ring
                ring.remove(req.client_id)
                self._rr = self._rr % len(ring) if ring else 0
            self._c["abandoned"].inc()
            self._g_queue_depth.set(
                sum(len(qq) for qq in self._queues.values()))
        self._fail_handle(handle, RequestAbandonedError(
            f"request {req.request_id} (client {req.client_id!r}) "
            f"canceled while queued"))
        self.telemetry.instant("abandoned", cat="serve",
                               request=req.request_id, client=req.client_id)
        return True

    @staticmethod
    def _fail_handle(handle: RequestHandle, err: BaseException) -> None:
        handle.error = err
        handle.completed_at = time.perf_counter()
        for f in handle.output_futures:
            f.fail(err)
        handle._done.set()

    def close(self, drain: bool = True) -> None:
        """Shut the runtime down.

        drain=True (default) first waits for every queued/in-flight
        request to finish.  drain=False fails fast: requests still
        QUEUED terminate immediately with `RuntimeClosedError` (no
        waiter hangs on work that will never run); requests already
        executing run to completion (a PBS round can't be stopped
        mid-flight) and their handles resolve normally."""
        if drain:
            self.drain()
        with self._lock:
            self._closed = True
            dropped = [h for q in self._queues.values() for h in q]
            self._queues.clear()
            self._client_ring.clear()
            self._rr = 0
            if dropped:
                self._c["abandoned"].inc(len(dropped))
            self._g_queue_depth.set(0)
        for h in dropped:
            self._fail_handle(h, RuntimeClosedError(
                f"request {h.request.request_id} was still queued when the "
                f"runtime closed"))
        for t in list(self._threads):
            t.join()

    # -- admission (round-robin across clients) + placement ------------------
    def _queue_depth_locked(self) -> int:
        return sum(len(q) for q in self._queues.values())

    def _place_locked(self) -> Optional[EngineShard]:
        """Pick the shard for the next admission: parameter-set filter,
        then least-loaded (fewest in-flight), then lowest index.  None
        when every eligible shard is at its limit."""
        params = self.ctx.params
        best = None
        for s in self.shards:
            if s.capacity <= 0 or not s.accepts(params):
                continue
            if best is None or s.inflight < best.inflight:
                best = s
        return best

    def _admit_locked(self) -> None:
        if self._closed:
            return
        workers = []
        while not self._paused:
            shard = self._place_locked()
            if shard is None:
                # fleet saturated: with a backlog, give every shard's
                # elastic controller a grow look (queue depth + its own
                # recent occupancy) and retry if any limit rose — this
                # makes ramp-up synchronous with demand, not timer-driven
                depth = self._queue_depth_locked()
                if depth and any([s.elastic_observe(depth)
                                  for s in self.shards]):
                    continue
                break
            handle = self._next_handle_locked()
            if handle is None:
                break
            # registers with the shard's fusion barrier BEFORE the
            # worker starts, so a wave of admissions fuses fully
            shard.acquire()
            handle.admitted_at = time.perf_counter()
            self._c["admitted"].inc()
            self._admitted_log.append(
                (handle.request.client_id, handle.request.request_id))
            self.telemetry.instant("admit", cat="serve",
                                   request=handle.request.request_id,
                                   client=handle.request.client_id,
                                   shard=shard.index)
            self._g_queue_depth.set(self._queue_depth_locked())
            workers.append(threading.Thread(target=self._worker,
                                            args=(handle, shard), daemon=True))
        # start the workers only once every admission of this pass holds
        # its barrier slot (the reference starts each as it is admitted,
        # and a worker that reaches its first PBS before the next
        # admission registers leads a round alone)
        for t in workers:
            self._threads.append(t)
            t.start()

    def _next_handle_locked(self) -> Optional[RequestHandle]:
        ring = self._client_ring
        nclients = len(ring)
        for step in range(nclients):
            idx = (self._rr + step) % nclients
            cid = ring[idx]
            q = self._queues.get(cid)
            if q:
                handle = q.popleft()
                if q:
                    self._rr = (idx + 1) % nclients
                else:
                    # drop the drained client so a long-lived server's
                    # ring/queue map doesn't grow with every client ever
                    # seen (resubmits re-enter at the ring's tail)
                    del self._queues[cid]
                    ring.pop(idx)
                    self._rr = idx % len(ring) if ring else 0
                return handle
        return None

    # -- execution -----------------------------------------------------------
    def _worker(self, handle: RequestHandle, shard: EngineShard) -> None:
        req = handle.request
        tel = self.telemetry
        # backfill the queue-wait interval (its endpoints were stamped by
        # the submitting thread and the admitting thread) onto this lane,
        # BEFORE the request span opens so the two stay disjoint siblings
        if handle.submitted_at is not None and handle.admitted_at is not None:
            wait_s = handle.admitted_at - handle.submitted_at
            tel.record("queue_wait", "serve", handle.submitted_at, wait_s,
                       request=req.request_id, client=req.client_id)
            self._h_queue_wait.observe(wait_s)
        span = tel.span("request", cat="serve", request=req.request_id,
                        client=req.client_id, shard=shard.index)
        interp = None
        with span:
            try:
                eng = shard.worker_engine(req.request_id)
                interp = IrInterpreter(self.ctx, eng,
                                       intra_fuse=self.intra_fuse,
                                       holds_slot=self.fused,
                                       telemetry=tel,
                                       request=req.request_id)
                attempt = {"n": 0}

                def on_node(node_id, value):
                    futs = handle._out_map.get(node_id)
                    if not futs:
                        return
                    ts = time.perf_counter()
                    for f in futs:
                        f.resolve(value, ts)

                def step():
                    attempt["n"] += 1
                    if self.fault_hook is not None:
                        self.fault_hook(req, attempt["n"])
                    return interp.run(req.graph, req.enc_inputs,
                                      on_node=on_node)

                runner = StepRunner(step, self.fault, telemetry=tel)
                try:
                    handle.result = runner.run()
                finally:
                    # count retries whether the request ultimately succeeded
                    # or exhausted its budget — retry storms from poisoned
                    # requests must show up in the stats
                    handle.retries = runner.stats["retries"]
            except BaseException as err:  # noqa: BLE001 — via handle
                handle.error = err
            finally:
                handle.completed_at = time.perf_counter()
                if handle.error is None:
                    # outputs the interpreter resolved early keep their
                    # timestamps; the rest (e.g. passthrough inputs)
                    # resolve now from the final result
                    for f in handle.output_futures:
                        f.resolve(handle.result[f.node_id],
                                  handle.completed_at)
                else:
                    for f in handle.output_futures:
                        f.fail(handle.error)
                if shard.scheduler is not None:
                    shard.scheduler.unregister()
                outcome = "completed" if handle.error is None else "failed"
                span.set(retries=handle.retries, outcome=outcome,
                         rounds=0 if interp is None else interp.rounds,
                         pbs=0 if interp is None else interp.pbs)
                tel.instant(outcome, cat="serve", request=req.request_id,
                            client=req.client_id, shard=shard.index)
                if handle.submitted_at is not None:
                    self._h_latency.observe(
                        handle.completed_at - handle.submitted_at)
                with self._lock:
                    shard.release(outcome)
                    self._c["retries"].inc(handle.retries)
                    self._c[outcome].inc()
                    # a completion with an empty queue is the elastic
                    # controller's shrink opportunity (ramp-down to idle)
                    shard.elastic_observe(self._queue_depth_locked())
                    # this worker stays listed until it has ended, so that
                    # `close()` joins it: a daemon thread still unwinding
                    # at interpreter exit aborts the process inside torch
                    self._threads = [t for t in self._threads if t.is_alive()]
                    self._admit_locked()
                handle._done.set()
