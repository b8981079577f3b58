"""Span tracing with a Chrome-trace exporter.  The port's own copy of
`repro.obs.trace` (pure Python, same names and semantics).

`TraceRecorder` gives every layer of the serve path a lock-cheap way to
record what happened when: each OS thread appends to its own buffer
(registered once per thread under a lock, then append-only with no
further locking), so tracing a fused serving wave does not serialize
the worker fleet.  Spans carry a name, a category, wall-clock interval
(`time.perf_counter` timebase) and a small args dict; `instant()`
records point events (submit/complete/retry markers) and `record()`
backfills an interval measured elsewhere (e.g. a request's queue wait,
whose endpoints were stamped by other threads).

Two export forms:

  * `events()` / `spans()` — the structured in-memory form tests
    assert against (sorted `SpanEvent`s);
  * `chrome_trace()` / `write(path)` — Chrome trace-event JSON
    (`{"traceEvents": [...]}`), loadable in Perfetto
    (https://ui.perfetto.dev) or chrome://tracing.  Complete events
    ("ph": "X") carry microsecond ts/dur; per-thread metadata events
    name the lanes.

`validate_chrome_trace` checks an exported file the way the CI smoke
lane does: valid JSON, required keys per event, and — per thread lane
— properly nested spans (intervals either disjoint or contained, never
partially overlapping).

The no-op twin (`NOOP_RECORDER`) is what a disabled `Telemetry` hands
out: `span()` returns a shared do-nothing context manager, so the hot
path pays one method call and a kwargs dict when tracing is off.
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
    thread: str               # thread name at first record
    args: dict


class _SpanCtx:
    """Context manager recording one span on the current thread."""

    __slots__ = ("_rec", "name", "cat", "args", "_t0")

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
        return self

    def __exit__(self, *exc) -> None:
        t1 = time.perf_counter()
        self._rec._append(self.name, self.cat, self._t0, t1 - self._t0,
                          self.args)


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
        self._lock = threading.Lock()
        self._buffers: list = []          # [(tid, thread_name, list)]
        self._tls = threading.local()

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
                args: dict) -> None:
        # list.append on a thread-owned list: no lock on the hot path
        self._buf().append((name, cat, ts, dur, args))

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

    # -- structured export (the in-memory form tests assert against) --------
    def events(self) -> list:
        """Every recorded event as `SpanEvent`s, sorted by start time."""
        with self._lock:
            snap = [(tid, tname, list(buf))
                    for tid, tname, buf in self._buffers]
        out = []
        for tid, tname, buf in snap:
            for name, cat, ts, dur, args in buf:
                out.append(SpanEvent(name, cat, ts, dur, tid, tname,
                                     dict(args)))
        out.sort(key=lambda e: e.ts)
        return out

    def spans(self) -> list:
        """Only the duration events (instants filtered out)."""
        return [e for e in self.events() if e.dur is not None]

    # -- Chrome trace-event export -------------------------------------------
    def chrome_trace(self) -> dict:
        """The recording as a Chrome trace-event object (Perfetto /
        chrome://tracing load it directly)."""
        trace_events = []
        seen_tids = set()
        for e in self.events():
            if e.tid not in seen_tids:
                seen_tids.add(e.tid)
                trace_events.append({
                    "name": "thread_name", "ph": "M", "pid": 1,
                    "tid": e.tid, "args": {"name": e.thread},
                })
            ev = {
                "name": e.name, "cat": e.cat, "pid": 1, "tid": e.tid,
                "ts": (e.ts - self._t0) * 1e6,
                "args": e.args,
            }
            if e.dur is None:
                ev["ph"] = "i"
                ev["s"] = "t"              # thread-scoped instant
            else:
                ev["ph"] = "X"
                ev["dur"] = e.dur * 1e6
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
