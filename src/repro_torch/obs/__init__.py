"""repro_torch.obs — tracing, metrics, and bandwidth accounting for the
port's serving stack: its own copy of `repro.obs` (pure Python, same
names and semantics; nothing here imports JAX or `repro`).

One `Telemetry` object threads through every layer of the serve path:

  metrics    typed counters/gauges/latency histograms in a
             `MetricsRegistry` (p50/p95/p99 from streaming quantile
             sketches), published by `ServeRuntime`,
             `FusedLutScheduler`, `IrInterpreter`, `IntegerContext`,
             and `TaurusEngine.lut_batch`; read through one
             `snapshot()` (also `ServeRuntime.metrics()`).
  tracing    request spans — submit -> queue-wait -> admit -> per-PBS-
             round (fused batch id, occupancy, dedup hits) ->
             complete/retry/fail — via a lock-cheap per-thread
             `TraceRecorder`, exportable as Chrome-trace JSON
             (Perfetto / chrome://tracing) or inspected in-memory.
             Spans hold the thread's CPU time too; on a card each fused
             round holds its device time from CUDA events, on the
             recorder's clock.
  bandwidth  a `BandwidthLedger` accounting BSK/KSK bytes streamed per
             fused round vs. the unfused counterfactual — the paper's
             key-reuse saving as a measured quantity.

Tracing is DISABLED by default: `Telemetry()` keeps the metrics
registry live but hands out a no-op recorder, so the hot path pays
~nothing when nobody is looking.  `Telemetry(trace=True)` turns the
recorder on; `Telemetry.disabled()` is the fully inert twin (no-op
metrics too).

    from repro_torch.obs import Telemetry

    tel = Telemetry(trace=True)
    rt = ServeRuntime(ctx, telemetry=tel)          # or Session(..., telemetry=tel)
    ...serve traffic...
    snap = rt.metrics()                            # == tel.snapshot()
    tel.write_chrome_trace("trace.json")           # open in Perfetto
"""
from __future__ import annotations

from repro_torch.obs.bandwidth import (NULL_LEDGER, BandwidthLedger, NullLedger,
                                       engine_key_bytes)
from repro_torch.obs.metrics import (NULL_REGISTRY, Counter, Gauge, Histogram,
                                     MetricsRegistry, NullRegistry, Snapshot,
                                     StatsView)
from repro_torch.obs.trace import (NOOP_RECORDER, NoopRecorder, SpanEvent,
                                   TraceRecorder, validate_chrome_trace)


class Telemetry:
    """The one telemetry handle every serve-path layer accepts.

    trace:   record spans (default False — no-op recorder).
    metrics: keep a live registry + bandwidth ledger (default True).
    """

    def __init__(self, *, trace: bool = False, metrics: bool = True):
        self.registry = MetricsRegistry() if metrics else NULL_REGISTRY
        self.recorder = TraceRecorder() if trace else NOOP_RECORDER
        self.bandwidth = BandwidthLedger() if metrics else NULL_LEDGER

    @classmethod
    def disabled(cls) -> "Telemetry":
        """Fully inert telemetry: every instrument is a shared no-op."""
        return cls(trace=False, metrics=False)

    @property
    def tracing(self) -> bool:
        return self.recorder.enabled

    # -- tracing -------------------------------------------------------------
    def span(self, name: str, cat: str = "serve", **args):
        return self.recorder.span(name, cat, **args)

    def instant(self, name: str, cat: str = "serve", **args) -> None:
        self.recorder.instant(name, cat, **args)

    def record(self, name: str, cat: str, ts: float, dur: float,
               **args) -> None:
        self.recorder.record(name, cat, ts, dur, **args)

    def chrome_trace(self) -> dict:
        return self.recorder.chrome_trace()

    def write_chrome_trace(self, path: str) -> str:
        import json
        with open(path, "w") as f:
            json.dump(self.chrome_trace(), f)
        return path

    # -- metrics -------------------------------------------------------------
    def counter(self, name: str) -> Counter:
        return self.registry.counter(name)

    def gauge(self, name: str) -> Gauge:
        return self.registry.gauge(name)

    def histogram(self, name: str, max_samples: int = 4096) -> Histogram:
        return self.registry.histogram(name, max_samples)

    def snapshot(self) -> Snapshot:
        """The single structured view: registry instruments plus the
        bandwidth ledger.  A `Snapshot`, so two phase-boundary calls
        diff into a windowed delta: ``later.diff(earlier)``."""
        snap = self.registry.snapshot()
        snap["bandwidth"] = self.bandwidth.snapshot()
        return snap


__all__ = [
    "BandwidthLedger", "Counter", "Gauge", "Histogram", "MetricsRegistry",
    "NOOP_RECORDER", "NULL_LEDGER", "NULL_REGISTRY", "NoopRecorder",
    "NullLedger", "NullRegistry", "Snapshot", "SpanEvent", "StatsView",
    "Telemetry",
    "TraceRecorder", "engine_key_bytes", "validate_chrome_trace",
]
