"""The two scenario runners.  The port of `repro.sim.runner`.

`run_scenario`       paces a Scenario's arrivals onto the WALL clock and
                     drives a real `ServeRuntime` — every request is a
                     real compiled graph over real big-key ciphertexts,
                     so its report carries measured serving latencies.

`simulate_scenario`  replays the SAME Scenario in virtual time: a
                     discrete-event loop over a K-slot service model
                     with a seeded per-request service-time draw.  No
                     crypto, no threads, no wall clock — two runs of the
                     same (scenario, max_inflight) produce reports that
                     are identical field for field, which is the
                     regression contract the tests and
                     `repro_torch.sim.suite`'s determinism check pin.

Both feed the same metric names (`serve.request_latency_s`,
`serve.queue_wait_s`, `serve.admitted/completed/abandoned`) into a
`repro_torch.obs.Telemetry`, snapshot it at phase boundaries, and hand the
`Snapshot.diff` windows plus client outcome tallies to `slo.evaluate` —
the SLO layer cannot tell the runners apart.

Client life cycle (both runners): a request that completes within its
deadline is DONE; completes late is TIMEOUT (the server had started it,
`RequestHandle.abandon()` refused); still queued at its deadline is
ABANDONED (`abandon()` removed it); rejected or errored is FAILED.  A
`drain=False` scenario ends with `ServeRuntime.close(drain=False)` —
the fail-fast shutdown — and everything still queued goes ABANDONED via
`RuntimeClosedError`.
"""
from __future__ import annotations

import dataclasses
import heapq
import itertools
import random
import threading
import time
from collections import deque
from typing import Optional

import torch

from repro_torch.core.integer import IntegerContext
from repro_torch.obs import Telemetry
from repro_torch.serve.runtime import (AdmissionError, RequestAbandonedError,
                                       RuntimeClosedError, ServeRuntime,
                                       SubmitValidationError)
from repro_torch.sim import clients as C
from repro_torch.sim.arrivals import arrival_plan, seeded_rng
from repro_torch.sim.slo import LATENCY_HIST, QUEUE_WAIT_HIST, evaluate


@dataclasses.dataclass
class SimRequest:
    """One planned request: the draw (workload + plaintext values) plus
    its life-cycle record."""
    req_id: int
    client_id: str
    workload: object
    values: list
    record: C.ClientRequest
    enc: Optional[list] = None          # real runner: pre-encrypted inputs
    started: bool = False               # virtual runner: service began


@dataclasses.dataclass
class ScenarioRun:
    """A runner's output: the SLO report plus the raw per-request
    records (state-machine audit trail)."""
    report: dict
    records: list


def default_service_model(workload, rng: random.Random) -> float:
    """Virtual service time: the workload's mean prior with ±30%
    uniform jitter from the request's own seeded stream."""
    return workload.mean_service_s * (0.7 + 0.6 * rng.random())


# --------------------------------------------------------------------------
# shared plan/draw helpers (same seeds ⇒ same traffic in both runners)
# --------------------------------------------------------------------------

def _open_loop_requests(scenario) -> list:
    plan = arrival_plan(scenario.arrival, scenario.population,
                        scenario.duration_s, scenario.seed)
    rng = seeded_rng("draw", scenario.seed)
    reqs = []
    for i, (t, cidx) in enumerate(plan):
        w = scenario.mix.sample(rng)
        reqs.append(SimRequest(
            i, f"client-{cidx}", w, w.sample_values(rng),
            C.ClientRequest(f"client-{cidx}", w.name, t,
                            t + scenario.deadline_s)))
    return reqs


def _client_rng(scenario, cidx: int) -> random.Random:
    return seeded_rng("client", scenario.seed, cidx)


def _draw_closed(scenario, cidx: int, rng: random.Random, t: float,
                 req_id: int) -> SimRequest:
    w = scenario.mix.sample(rng)
    return SimRequest(req_id, f"client-{cidx}", w, w.sample_values(rng),
                      C.ClientRequest(f"client-{cidx}", w.name, t,
                                      t + scenario.deadline_s))


def _phase_windows(scenario, snaps: list, records: list) -> tuple:
    """Diff the boundary snapshots into per-phase windows and attribute
    each terminal record to the phase its finish time falls in (the
    last phase absorbs post-cutoff drain spillover)."""
    phase_list = scenario.phase_list()
    ends = [end for _, end in phase_list]

    def phase_idx(t: float) -> int:
        for i, end in enumerate(ends):
            if t <= end:
                return i
        return len(ends) - 1

    recs = [r.record for r in records]
    by_phase: list = [[] for _ in ends]
    for rec in recs:
        if rec.finish_s is not None:
            by_phase[phase_idx(rec.finish_s)].append(rec)
    windows = []
    for i, (phase, _) in enumerate(phase_list):
        delta = snaps[i + 1].diff(snaps[i])
        windows.append((phase.name, phase.duration_s, delta,
                        C.outcome_counts(by_phase[i])))
    overall_delta = snaps[-1].diff(snaps[0])
    return windows, overall_delta, C.outcome_counts(recs)


# --------------------------------------------------------------------------
# deterministic virtual-time runner
# --------------------------------------------------------------------------

def simulate_scenario(scenario, *, max_inflight: int = 4,
                      service_model=default_service_model) -> ScenarioRun:
    """Discrete-event replay on the virtual clock.

    Service is a K-slot pool (K = max_inflight, mirroring the runtime's
    worker count) over a FIFO queue; each request's service time comes
    from `service_model(workload, rng)` with an rng seeded by
    (scenario.seed, request id) — so the full report is a pure function
    of (scenario, max_inflight, service_model)."""
    tel = Telemetry()
    h_lat = tel.histogram(LATENCY_HIST)
    h_qw = tel.histogram(QUEUE_WAIT_HIST)
    c_adm = tel.counter("serve.admitted")
    c_done = tel.counter("serve.completed")
    c_aband = tel.counter("serve.abandoned")

    events: list = []
    seq = itertools.count()
    req_ids = itertools.count()
    records: list = []
    queue: deque = deque()
    free = max_inflight
    closed = False
    clrngs = {i: _client_rng(scenario, i)
              for i in range(scenario.population)}

    def push(t: float, kind: str, payload) -> None:
        heapq.heappush(events, (t, next(seq), kind, payload))

    if scenario.arrival.open_loop:
        for r in _open_loop_requests(scenario):
            push(r.record.arrival_s, "arrive", r)
    else:
        for cidx in range(scenario.population):
            t0 = scenario.arrival.first_arrival(cidx, clrngs[cidx])
            push(t0, "arrive", _draw_closed(scenario, cidx, clrngs[cidx],
                                            t0, next(req_ids)))

    def start(r: SimRequest, t: float) -> None:
        nonlocal free
        free -= 1
        r.started = True
        h_qw.observe(t - r.record.arrival_s)
        rng = seeded_rng("svc", scenario.seed, r.req_id)
        push(t + service_model(r.workload, rng), "finish", r)

    def next_closed(r: SimRequest, t: float) -> None:
        """Closed loop: after a terminal state, think, then rearrive."""
        if scenario.arrival.open_loop or closed:
            return
        cidx = int(r.client_id.split("-")[-1])
        t_next = t + scenario.arrival.think(clrngs[cidx])
        if t_next < scenario.duration_s:
            push(t_next, "arrive",
                 _draw_closed(scenario, cidx, clrngs[cidx], t_next,
                              next(req_ids)))

    snaps = [tel.snapshot()]
    ends = [end for _, end in scenario.phase_list()]
    interior = ends[:-1]
    bidx = 0

    while events:
        t, _, kind, r = heapq.heappop(events)
        while bidx < len(interior) and t > interior[bidx]:
            snaps.append(tel.snapshot())
            bidx += 1
        if not closed and not scenario.drain and t > scenario.duration_s:
            # fail-fast close at the cutoff: queued work is dropped with
            # RuntimeClosedError; in-service requests run to completion
            closed = True
            while queue:
                q = queue.popleft()
                c_aband.inc()
                q.record.transition(C.ABANDONED, scenario.duration_s)
        if kind == "arrive":
            records.append(r)
            r.record.transition(C.SUBMIT)
            if closed:
                r.record.transition(C.ABANDONED, t)
                c_aband.inc()
                continue
            c_adm.inc()
            r.record.transition(C.WAITING)
            push(r.record.deadline_s, "deadline", r)
            if free > 0:
                start(r, t)
            else:
                queue.append(r)
        elif kind == "deadline":
            if r.record.state == C.WAITING and not r.started:
                queue.remove(r)
                c_aband.inc()
                r.record.transition(C.ABANDONED, t)
                next_closed(r, t)
        elif kind == "finish":
            free += 1
            h_lat.observe(t - r.record.arrival_s)
            c_done.inc()
            late = t > r.record.deadline_s
            r.record.transition(C.TIMEOUT if late else C.DONE, t)
            next_closed(r, t)
            while free > 0 and queue:
                start(queue.popleft(), t)

    while bidx <= len(interior):             # remaining boundaries + final
        snaps.append(tel.snapshot())
        bidx += 1

    windows, overall_delta, overall = _phase_windows(scenario, snaps,
                                                     records)
    report = evaluate(scenario, windows, overall_delta, overall,
                      runner="virtual")
    report["max_inflight"] = max_inflight
    return ScenarioRun(report, records)


# --------------------------------------------------------------------------
# real wall-clock runner
# --------------------------------------------------------------------------

class _RealDriver:
    """Shared machinery of the open-/closed-loop wall-clock drivers."""

    def __init__(self, scenario, ctx, engine, *, max_inflight: int,
                 time_scale: float, validate: bool, fused: bool,
                 shards: int = 1, elastic=None):
        self.scenario = scenario
        self.time_scale = time_scale
        self.validate = validate
        self.tel = Telemetry()
        self.rt = ServeRuntime(ctx, engine, max_inflight=max_inflight,
                               fused=fused, shards=shards, elastic=elastic,
                               telemetry=self.tel)
        self.ic = IntegerContext.create(ctx, self.rt.engine)
        self.records: list = []
        self._rec_lock = threading.Lock()
        self.t0: float = 0.0

    # virtual <-> wall clock
    def vnow(self) -> float:
        return (time.perf_counter() - self.t0) / self.time_scale

    def sleep_until(self, t_virtual: float) -> None:
        delay = self.t0 + t_virtual * self.time_scale - time.perf_counter()
        if delay > 0:
            time.sleep(delay)

    def encrypt(self, r: SimRequest) -> None:
        """Encrypt `r`'s values from a generator of its own, seeded with
        the reference's per-request key number: closed-loop clients
        encrypt on their own threads, and no generator is shared."""
        gen = torch.Generator(device=self.ic.ctx.device)
        gen.manual_seed(self.scenario.seed * 100003 + r.req_id)
        r.enc = r.workload.encrypt(self.ic, gen, r.values)

    def submit(self, r: SimRequest):
        """SUBMIT transition + runtime admission; returns the handle or
        None after recording a terminal submit-path outcome."""
        r.record.transition(C.SUBMIT)
        with self._rec_lock:
            self.records.append(r)
        graph, _, _ = r.workload.build()
        try:
            h = self.rt.submit(graph, r.enc, client_id=r.client_id)
        except RuntimeClosedError:
            r.record.transition(C.ABANDONED, self.vnow())
            return None
        except (AdmissionError, SubmitValidationError):
            r.record.transition(C.FAILED, self.vnow())
            return None
        r.record.transition(C.WAITING)
        return h

    def await_outcome(self, r: SimRequest, handle) -> None:
        """The client side of one in-flight request: wait to the
        deadline, abandon if still queued, otherwise ride it out."""
        wall_deadline = self.t0 + r.record.deadline_s * self.time_scale
        outcome = None
        try:
            handle.wait(timeout=max(0.0,
                                    wall_deadline - time.perf_counter()))
            outcome = C.DONE
        except TimeoutError:
            if handle.abandon():
                outcome = C.ABANDONED
            else:
                try:                         # already executing: ride out
                    handle.wait()
                    outcome = C.TIMEOUT
                except (RequestAbandonedError, RuntimeClosedError):
                    outcome = C.ABANDONED
                except Exception:            # noqa: BLE001 — server error
                    outcome = C.FAILED
        except (RequestAbandonedError, RuntimeClosedError):
            outcome = C.ABANDONED
        except Exception:                    # noqa: BLE001 — server error
            outcome = C.FAILED
        if outcome == C.DONE and self.validate \
                and r.workload.oracle is not None:
            got = r.workload.decrypt(self.ic, handle.outputs())
            r.record.ok_payload = (got == r.workload.oracle(r.values))
        r.record.transition(outcome, self.vnow())


def run_scenario(scenario, ctx, engine=None, *, max_inflight: int = 4,
                 time_scale: float = 1.0, validate: bool = False,
                 fused: bool = True, shards: int = 1,
                 elastic=None) -> ScenarioRun:
    """Drive the scenario against a real `ServeRuntime` on the wall
    clock (virtual seconds × `time_scale`).  Open-loop traffic is drawn
    and pre-encrypted before the clock starts, so the measured window
    contains serving work only; closed-loop clients encrypt inline (the
    client's own think-time work).  validate=True decrypts every DONE
    request and checks it against the workload's integer oracle.
    `shards`/`elastic` thread straight to `ServeRuntime` — the scenario
    plays against a sharded router exactly as production traffic would
    (`max_inflight` then bounds each shard, not the whole runtime)."""
    d = _RealDriver(scenario, ctx, engine, max_inflight=max_inflight,
                    time_scale=time_scale, validate=validate, fused=fused,
                    shards=shards, elastic=elastic)
    try:
        return _run_real(d, scenario)
    finally:
        d.rt.close()


def _run_real(d: _RealDriver, scenario) -> ScenarioRun:
    waiters: list = []
    interior = [end for _, end in scenario.phase_list()][:-1]
    snaps: list = []

    def spawn_waiter(r: SimRequest, handle) -> None:
        t = threading.Thread(target=d.await_outcome, args=(r, handle),
                             daemon=True)
        t.start()
        waiters.append(t)

    if scenario.arrival.open_loop:
        reqs = _open_loop_requests(scenario)
        for r in reqs:
            d.encrypt(r)
        client_threads: list = []
    else:
        reqs = []

        def client_loop(cidx: int) -> None:
            rng = _client_rng(scenario, cidx)
            t_next = scenario.arrival.first_arrival(cidx, rng)
            n = 0
            while t_next < scenario.duration_s:
                d.sleep_until(t_next)
                r = _draw_closed(scenario, cidx, rng, d.vnow(),
                                 cidx * 1_000_000 + n)
                n += 1
                d.encrypt(r)
                va = d.vnow()
                r.record.arrival_s = va
                r.record.deadline_s = va + scenario.deadline_s
                h = d.submit(r)
                if h is not None:
                    d.await_outcome(r, h)    # one outstanding per client
                t_next = d.vnow() + scenario.arrival.think(rng)

        client_threads = [threading.Thread(target=client_loop, args=(i,),
                                           daemon=True)
                          for i in range(scenario.population)]

    d.t0 = time.perf_counter()
    snaps.append(d.rt.metrics())
    bidx = 0

    def snap_boundaries_until(t_virtual: float) -> None:
        nonlocal bidx
        while bidx < len(interior) and interior[bidx] <= t_virtual:
            d.sleep_until(interior[bidx])
            snaps.append(d.rt.metrics())
            bidx += 1

    if scenario.arrival.open_loop:
        for r in reqs:
            snap_boundaries_until(r.record.arrival_s)
            d.sleep_until(r.record.arrival_s)
            h = d.submit(r)
            if h is not None:
                spawn_waiter(r, h)
    else:
        for t in client_threads:
            t.start()

    snap_boundaries_until(scenario.duration_s)
    d.sleep_until(scenario.duration_s)

    if scenario.drain:
        d.rt.drain()
    else:
        d.rt.close(drain=False)              # fail-fast: queued ⇒ closed
    for t in client_threads:
        t.join()
    for t in waiters:
        t.join()
    snaps.append(d.rt.metrics())

    windows, overall_delta, overall = _phase_windows(scenario, snaps,
                                                     d.records)
    report = evaluate(scenario, windows, overall_delta, overall,
                      runner="real")
    report["max_inflight"] = d.rt.max_inflight
    report["shards"] = d.rt.n_shards
    report["time_scale"] = d.time_scale
    return ScenarioRun(report, d.records)
