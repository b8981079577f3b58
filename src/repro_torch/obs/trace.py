"""Span tracing with a Chrome-trace exporter.  The port's own copy of
`repro.obs.trace` (pure Python, same names and semantics), with three
additions: spans record the thread's CPU time, device intervals from
CUDA events share the recorder's clock, and spans map onto the clock of
`torch.profiler`'s events.

`TraceRecorder` gives every layer of the serve path a lock-cheap way to
record what happened when: each OS thread appends to its own buffer
(registered once per thread under a lock, then append-only with no
further locking), so tracing a fused serving wave does not serialize
the worker fleet.  Spans carry a name, a category, wall-clock interval
(`time.perf_counter` timebase), the thread's CPU time over it
(`time.thread_time`: a worker's busy time, without its wait for the
interpreter lock) and a small args dict; `instant()` records point
events (submit/complete/retry markers) and `record()` backfills an
interval measured elsewhere (e.g. a request's queue wait, whose
endpoints were stamped by other threads).

Device time: `cuda_event(device)` records a timing event on the
device's current stream and `device_interval(span, start, end, chain)`
hands a pair of them to the recorder, which resolves them with
`Event.query()` as later intervals come in (no wait while serving) and
sets `device_ms` (and, after an earlier interval of the same chain,
`device_gap_ms`) on the span's args.  The recorder's first event on a
device anchors that device's clock to `perf_counter` with one
synchronize; the intervals then form one `device_round` lane per
device beside the thread lanes.

Two export forms:

  * `events()` / `spans()` — the structured in-memory form tests
    assert against (sorted `SpanEvent`s; both wait for pending device
    intervals first);
  * `chrome_trace()` / `write(path)` — Chrome trace-event JSON
    (`{"traceEvents": [...]}`), loadable in Perfetto
    (https://ui.perfetto.dev) or chrome://tracing.  Complete events
    ("ph": "X") carry microsecond ts/dur and the CPU time as
    `args["cpu_us"]`; per-thread metadata events name the lanes.

`to_profiler_us(ts)` maps a recorder timestamp onto the unix-epoch
microseconds on which `torch.profiler` stamps its events (its Chrome
export writes them less its `baseTimeNanoseconds`).

`validate_chrome_trace` checks an exported file the way the CI smoke
lane does: valid JSON, required keys per event, and — per thread lane
— properly nested spans (intervals either disjoint or contained, never
partially overlapping).

The no-op twin (`NOOP_RECORDER`) is what a disabled `Telemetry` hands
out: `span()` returns a shared do-nothing context manager, so the hot
path pays one method call and a kwargs dict when tracing is off, and
reads no clock.
"""
from __future__ import annotations

import dataclasses
import json
import threading
import time
from typing import Optional


@dataclasses.dataclass(frozen=True)
class SpanEvent:
    """One recorded event: a span (dur is not None) or an instant."""
    name: str
    cat: str
    ts: float                 # perf_counter seconds (recorder timebase)
    dur: Optional[float]      # seconds; None for instant events
    tid: int                  # small per-recorder thread lane id
                              # (a device lane's is negative)
    thread: str               # thread name at first record
    args: dict
    cpu: Optional[float] = None   # the thread's CPU seconds over a span;
                                  # None for instants, backfills, devices


class _SpanCtx:
    """Context manager recording one span on the current thread."""

    __slots__ = ("_rec", "name", "cat", "args", "_t0", "_c0")

    def __init__(self, rec: "TraceRecorder", name: str, cat: str, args: dict):
        self._rec = rec
        self.name = name
        self.cat = cat
        self.args = args

    def set(self, **kw) -> None:
        """Attach args discovered mid-span (e.g. the fused batch id a
        round landed in, known only once the leader dispatched)."""
        self.args.update(kw)

    def __enter__(self) -> "_SpanCtx":
        self._t0 = time.perf_counter()
        self._c0 = time.thread_time()
        return self

    def __exit__(self, *exc) -> None:
        c1 = time.thread_time()
        t1 = time.perf_counter()
        self._rec._append(self.name, self.cat, self._t0, t1 - self._t0,
                          self.args, c1 - self._c0)


class _NoopSpan:
    """Shared do-nothing span for disabled tracing."""

    __slots__ = ()

    def set(self, **kw) -> None:
        pass

    def __enter__(self) -> "_NoopSpan":
        return self

    def __exit__(self, *exc) -> None:
        pass


_NOOP_SPAN = _NoopSpan()


class NoopRecorder:
    """Recorder twin that records nothing (tracing disabled)."""

    enabled = False

    def span(self, name: str, cat: str = "serve", **args) -> _NoopSpan:
        return _NOOP_SPAN

    def instant(self, name: str, cat: str = "serve", **args) -> None:
        pass

    def record(self, name: str, cat: str, ts: float, dur: float,
               **args) -> None:
        pass

    def events(self) -> list:
        return []

    def spans(self) -> list:
        return []

    def chrome_trace(self) -> dict:
        return {"traceEvents": []}


NOOP_RECORDER = NoopRecorder()


class TraceRecorder:
    """Per-thread-buffered span recorder (see module docstring)."""

    enabled = True

    def __init__(self):
        self._t0 = time.perf_counter()
        # torch.profiler's unix-epoch clock, read beside perf_counter
        self._epoch_ns = time.time_ns()
        self._perf_ns = time.perf_counter_ns()
        self._lock = threading.Lock()
        self._buffers: list = []          # [(tid, thread_name, list)]
        self._tls = threading.local()
        self._anchors: dict = {}          # device index -> (event, perf s)
        self._chain_end: dict = {}        # chain -> its last end event
        self._pending: list = []          # device intervals not yet run
        self._device: list = []           # (device index, ts, dur, args)

    # -- recording -----------------------------------------------------------
    def _buf(self) -> list:
        buf = getattr(self._tls, "buf", None)
        if buf is None:
            buf = []
            with self._lock:
                tid = len(self._buffers)
                self._buffers.append(
                    (tid, threading.current_thread().name, buf))
            self._tls.buf = buf
            self._tls.tid = tid
        return buf

    def _append(self, name: str, cat: str, ts: float, dur: Optional[float],
                args: dict, cpu: Optional[float] = None) -> None:
        # list.append on a thread-owned list: no lock on the hot path
        self._buf().append((name, cat, ts, dur, args, cpu))

    def span(self, name: str, cat: str = "serve", **args) -> _SpanCtx:
        """Open a span on the current thread::

            with recorder.span("fused_round", cat="sched", round=7) as sp:
                ...
                sp.set(rows=48)
        """
        return _SpanCtx(self, name, cat, args)

    def instant(self, name: str, cat: str = "serve", **args) -> None:
        self._append(name, cat, time.perf_counter(), None, args)

    def record(self, name: str, cat: str, ts: float, dur: float,
               **args) -> None:
        """Backfill an interval whose endpoints were measured elsewhere
        (perf_counter timebase); lands on the calling thread's lane."""
        self._append(name, cat, ts, dur, args)

    def to_profiler_us(self, ts: float) -> float:
        """A recorder timestamp (perf_counter seconds) on torch.profiler's
        clock: unix-epoch microseconds."""
        return self._epoch_ns / 1e3 + (ts - self._perf_ns / 1e9) * 1e6

    # -- device intervals (CUDA events) --------------------------------------
    def cuda_event(self, device):
        """A timing event recorded now on `device`'s current stream.  The
        recorder's first event on a device anchors the device's clock to
        perf_counter: one synchronize, once."""
        import torch
        stream = torch.cuda.current_stream(device)
        idx = stream.device_index
        if idx not in self._anchors:
            with self._lock:
                if idx not in self._anchors:
                    torch.cuda.synchronize(idx)
                    t = time.perf_counter()
                    anchor = torch.cuda.Event(enable_timing=True)
                    anchor.record(stream)
                    self._anchors[idx] = (anchor, t)
        ev = torch.cuda.Event(enable_timing=True)
        ev.record(stream)
        return ev

    def device_interval(self, span: _SpanCtx, start, end, chain) -> None:
        """Hand the recorder the device interval between two `cuda_event`s
        of `span` (recorded or not).  Once the end event has run, the
        span's args get `device_ms` and, after an earlier interval of the
        same `chain` (one engine's rounds), `device_gap_ms` from that
        interval's end to this one's start.  Resolves every interval
        whose end has run, without waiting; `events()` waits for the
        rest."""
        with self._lock:
            prev = self._chain_end.get(chain)
            self._chain_end[chain] = end
            self._pending.append((start, end, prev, span.args))
        self._resolve(wait=False)

    def _resolve(self, wait: bool) -> None:
        with self._lock:
            pending, self._pending = self._pending, []
        keep, done = [], []
        for item in pending:
            start, end, prev, args = item
            if wait:
                end.synchronize()
            elif not end.query():
                keep.append(item)
                continue
            idx = start.device.index
            anchor, t = self._anchors[idx]
            ms = start.elapsed_time(end)
            args["device_ms"] = ms
            if prev is not None:
                args["device_gap_ms"] = prev.elapsed_time(start)
            done.append((idx, t + anchor.elapsed_time(start) / 1e3,
                         ms / 1e3, args))
        with self._lock:
            self._pending[:0] = keep
            self._device += done

    # -- structured export (the in-memory form tests assert against) --------
    def events(self) -> list:
        """Every recorded event as `SpanEvent`s, sorted by start time:
        the threads' spans and instants, and the devices' intervals
        (`device_round`, on lane -1 - device index)."""
        self._resolve(wait=True)
        with self._lock:
            snap = [(tid, tname, list(buf))
                    for tid, tname, buf in self._buffers]
            device = list(self._device)
        out = []
        for tid, tname, buf in snap:
            for name, cat, ts, dur, args, cpu in buf:
                out.append(SpanEvent(name, cat, ts, dur, tid, tname,
                                     dict(args), cpu))
        for idx, ts, dur, args in device:
            out.append(SpanEvent("device_round", "device", ts, dur, -1 - idx,
                                 f"cuda:{idx}", dict(args)))
        out.sort(key=lambda e: e.ts)
        return out

    def spans(self) -> list:
        """Only the duration events (instants filtered out)."""
        return [e for e in self.events() if e.dur is not None]

    # -- Chrome trace-event export -------------------------------------------
    def chrome_trace(self) -> dict:
        """The recording as a Chrome trace-event object (Perfetto /
        chrome://tracing load it directly).  A device lane shows each
        interval from where the one before it ended: two leaders
        enqueueing on one stream at once (shards on one card) interleave
        their rounds there."""
        trace_events = []
        seen_tids = set()
        lane_end: dict = {}
        for e in self.events():
            if e.tid not in seen_tids:
                seen_tids.add(e.tid)
                trace_events.append({
                    "name": "thread_name", "ph": "M", "pid": 1,
                    "tid": e.tid, "args": {"name": e.thread},
                })
            ts, dur, args = e.ts, e.dur, e.args
            if e.tid < 0:
                ts = max(ts, lane_end.get(e.tid, ts))
                dur = max(0.0, e.ts + e.dur - ts)
                lane_end[e.tid] = ts + dur
            if e.cpu is not None:
                args = dict(args, cpu_us=e.cpu * 1e6)
            ev = {
                "name": e.name, "cat": e.cat, "pid": 1, "tid": e.tid,
                "ts": (ts - self._t0) * 1e6,
                "args": args,
            }
            if dur is None:
                ev["ph"] = "i"
                ev["s"] = "t"              # thread-scoped instant
            else:
                ev["ph"] = "X"
                ev["dur"] = dur * 1e6
            trace_events.append(ev)
        return {"traceEvents": trace_events, "displayTimeUnit": "ms"}

    def write(self, path: str) -> str:
        with open(path, "w") as f:
            json.dump(self.chrome_trace(), f)
        return path


def validate_chrome_trace(trace) -> int:
    """Validate a Chrome trace: `trace` is a path, a JSON string, or an
    already-decoded object.  Checks JSON shape, per-event required keys,
    and per-lane span nesting (no partial overlaps).  Returns the number
    of trace events; raises ValueError on any violation."""
    if isinstance(trace, str):
        if trace.lstrip().startswith(("{", "[")):
            obj = json.loads(trace)
        else:
            with open(trace) as f:
                obj = json.load(f)
    else:
        obj = trace
    events = obj["traceEvents"] if isinstance(obj, dict) else obj
    if not isinstance(events, list):
        raise ValueError("trace must be a list or {'traceEvents': [...]}")
    lanes: dict = {}
    for i, ev in enumerate(events):
        for key in ("name", "ph", "pid", "tid"):
            if key not in ev:
                raise ValueError(f"event {i} missing {key!r}: {ev!r}")
        if ev["ph"] == "X":
            if "ts" not in ev or "dur" not in ev or ev["dur"] < 0:
                raise ValueError(f"complete event {i} needs ts/dur: {ev!r}")
            lanes.setdefault((ev["pid"], ev["tid"]), []).append(
                (float(ev["ts"]), float(ev["ts"]) + float(ev["dur"]),
                 ev["name"]))
    eps = 1e-3                             # 1ns in trace microseconds
    for lane, spans in lanes.items():
        spans.sort(key=lambda s: (s[0], -s[1]))
        stack: list = []
        for start, end, name in spans:
            while stack and start >= stack[-1][0] - eps:
                stack.pop()
            if stack and end > stack[-1][0] + eps:
                raise ValueError(
                    f"lane {lane}: span {name!r} [{start}, {end}] partially "
                    f"overlaps enclosing {stack[-1][1]!r} ending at "
                    f"{stack[-1][0]}")
            stack.append((end, name))
    return len(events)
