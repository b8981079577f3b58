"""Typed metrics: counters, gauges, and latency histograms behind one
`MetricsRegistry` with a single `snapshot()` contract.  The port's own
copy of `repro.obs.metrics` (pure Python, same names and semantics).

Every layer of the serve path publishes here — `ServeRuntime` request
outcomes, `FusedLutScheduler` round composition, `IntegerContext` /
`TaurusEngine.lut_batch` PBS accounting — so one snapshot shows the
whole stack.  Instruments are cheap (one small lock each, no
allocation on the hot path) and process-local; nothing is exported
anywhere unless a caller reads `snapshot()`.

Histograms answer tail-latency questions (p50/p95/p99) through a
streaming quantile sketch: exact up to `max_samples` observations,
then uniform reservoir sampling (Vitter's algorithm R with a seeded
RNG, so summaries are reproducible).  `count`/`sum`/`min`/`max` are
always exact regardless of reservoir state.

`StatsView` is the backward-compatibility bridge: the serve layer's
historical ad-hoc ``stats`` dicts (`ServeRuntime.stats`,
`FusedLutScheduler.stats`) are now read-only mapping views over
registry counters (plus the bounded observability logs), so existing
key names keep working while `snapshot()` is the one source of truth.
"""
from __future__ import annotations

import random
import threading
from collections.abc import Mapping
from typing import Iterator, Optional


class Counter:
    """Monotonic counter; `inc` is thread-safe and exact."""

    __slots__ = ("name", "_lock", "_value")

    def __init__(self, name: str):
        self.name = name
        self._lock = threading.Lock()
        self._value = 0

    def inc(self, n: int = 1) -> None:
        with self._lock:
            self._value += n

    @property
    def value(self) -> int:
        return self._value

    def __repr__(self) -> str:
        return f"Counter({self.name}={self._value})"


class Gauge:
    """Last-write-wins sampled value (e.g. current queue depth)."""

    __slots__ = ("name", "_lock", "_value")

    def __init__(self, name: str):
        self.name = name
        self._lock = threading.Lock()
        self._value = 0.0

    def set(self, v: float) -> None:
        with self._lock:
            self._value = float(v)

    @property
    def value(self) -> float:
        return self._value

    def __repr__(self) -> str:
        return f"Gauge({self.name}={self._value})"


class Histogram:
    """Streaming distribution sketch: exact count/sum/min/max, quantiles
    from a bounded reservoir (exact until `max_samples` observations)."""

    __slots__ = ("name", "_lock", "count", "total", "min", "max",
                 "_cap", "_samples", "_rng")

    def __init__(self, name: str, max_samples: int = 4096):
        self.name = name
        self._lock = threading.Lock()
        self.count = 0
        self.total = 0.0
        self.min: Optional[float] = None
        self.max: Optional[float] = None
        self._cap = max_samples
        self._samples: list = []
        # seeded so repeated runs summarize identically (reproducible
        # benchmarks); the reservoir only engages past `max_samples`
        self._rng = random.Random(0x5EED)

    def observe(self, v: float) -> None:
        v = float(v)
        with self._lock:
            self.count += 1
            self.total += v
            if self.min is None or v < self.min:
                self.min = v
            if self.max is None or v > self.max:
                self.max = v
            if len(self._samples) < self._cap:
                self._samples.append(v)
            else:                       # reservoir: keep a uniform sample
                j = self._rng.randrange(self.count)
                if j < self._cap:
                    self._samples[j] = v

    def quantile(self, q: float) -> Optional[float]:
        """Estimated q-quantile (exact while count <= max_samples)."""
        with self._lock:
            if not self._samples:
                return None
            s = sorted(self._samples)
        idx = min(len(s) - 1, max(0, int(q * len(s))))
        return s[idx]

    def sample_state(self) -> Optional[tuple]:
        """(count, samples-in-observation-order) while the sketch is
        still exact (count <= max_samples), else None.  `Snapshot.diff`
        slices two exact states into interval quantiles; once the
        reservoir engages, sample order no longer matches observation
        order and interval quantiles are unsupported."""
        with self._lock:
            if self.count > self._cap:
                return None
            return self.count, tuple(self._samples)

    @property
    def mean(self) -> Optional[float]:
        return self.total / self.count if self.count else None

    def summary(self) -> dict:
        return {
            "count": self.count,
            "sum": self.total,
            "mean": self.mean,
            "min": self.min,
            "max": self.max,
            "p50": self.quantile(0.50),
            "p95": self.quantile(0.95),
            "p99": self.quantile(0.99),
        }

    def __repr__(self) -> str:
        return f"Histogram({self.name}, n={self.count})"


def _interval_summary(later_state: Optional[tuple],
                      earlier_count: int) -> Optional[dict]:
    """Summary of the observations made BETWEEN two exact sample states.

    Histograms are append-only until the reservoir engages, so the
    interval's observations are precisely `later_samples[earlier_count:]`
    — exact interval quantiles, not a subtraction heuristic.  Returns
    None when the later sketch is no longer exact (reservoir engaged)."""
    if later_state is None:
        return None
    _, samples = later_state
    window = list(samples[earlier_count:])
    if not window:
        return {"count": 0, "sum": 0.0, "mean": None, "min": None,
                "max": None, "p50": None, "p95": None, "p99": None}
    window.sort()
    n = len(window)

    def q(p: float) -> float:
        return window[min(n - 1, max(0, int(p * n)))]

    total = sum(window)
    return {"count": n, "sum": total, "mean": total / n,
            "min": window[0], "max": window[-1],
            "p50": q(0.50), "p95": q(0.95), "p99": q(0.99)}


class Snapshot(dict):
    """`MetricsRegistry.snapshot()`'s return type: a plain dict (JSON-
    serializable, existing ``snap["histograms"][...]["p99"]`` consumers
    unaffected) that additionally supports windowed deltas via `diff`.

    `diff(earlier)` is what per-phase SLO evaluation needs: counters
    subtract, gauges pass through the later sample, histograms report
    the INTERVAL's quantiles where supported (both snapshots taken
    while the sketch was exact; otherwise count/sum/mean still subtract
    but quantiles are None), and a ``bandwidth`` key — attached by
    `Telemetry.snapshot` — subtracts numeric leaves."""

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        # hist name -> (count, samples) while exact; not a dict item so
        # json.dump and == against plain dicts behave unchanged
        self.raw_samples: dict = {}

    def diff(self, earlier: "Snapshot") -> "Snapshot":
        out = Snapshot()
        e_counters = earlier.get("counters", {})
        out["counters"] = {n: v - e_counters.get(n, 0)
                           for n, v in self.get("counters", {}).items()}
        # gauges are point-in-time samples; the later value IS the
        # window's reading (subtracting queue depths is meaningless)
        out["gauges"] = dict(self.get("gauges", {}))
        hists = {}
        e_hists = earlier.get("histograms", {})
        for name, s in self.get("histograms", {}).items():
            e = e_hists.get(name, {"count": 0, "sum": 0.0})
            interval = _interval_summary(self.raw_samples.get(name),
                                         e.get("count", 0))
            if interval is None:
                # reservoir engaged: exact totals, no interval quantiles
                n = s["count"] - e.get("count", 0)
                total = s["sum"] - e.get("sum", 0.0)
                interval = {"count": n, "sum": total,
                            "mean": total / n if n else None,
                            "min": None, "max": None,
                            "p50": None, "p95": None, "p99": None}
            hists[name] = interval
        out["histograms"] = hists
        if "bandwidth" in self:
            e_bw = earlier.get("bandwidth", {})
            out["bandwidth"] = {
                k: (v - e_bw.get(k, 0)
                    if isinstance(v, (int, float)) else v)
                for k, v in self["bandwidth"].items()}
        return out


class MetricsRegistry:
    """Named instrument registry; `counter`/`gauge`/`histogram` are
    get-or-create (same name -> same instrument, so publishers in
    different layers can share one series)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: dict = {}
        self._gauges: dict = {}
        self._histograms: dict = {}

    def counter(self, name: str) -> Counter:
        with self._lock:
            c = self._counters.get(name)
            if c is None:
                c = self._counters[name] = Counter(name)
            return c

    def gauge(self, name: str) -> Gauge:
        with self._lock:
            g = self._gauges.get(name)
            if g is None:
                g = self._gauges[name] = Gauge(name)
            return g

    def histogram(self, name: str, max_samples: int = 4096) -> Histogram:
        with self._lock:
            h = self._histograms.get(name)
            if h is None:
                h = self._histograms[name] = Histogram(name, max_samples)
            return h

    def snapshot(self) -> Snapshot:
        """One structured view of every instrument: counters as ints,
        gauges as floats, histograms as p50/p95/p99 summaries.  The
        returned `Snapshot` supports `.diff(earlier)` for windowed
        per-phase deltas."""
        with self._lock:
            counters = dict(self._counters)
            gauges = dict(self._gauges)
            hists = dict(self._histograms)
        snap = Snapshot({
            "counters": {n: c.value for n, c in sorted(counters.items())},
            "gauges": {n: g.value for n, g in sorted(gauges.items())},
            "histograms": {n: h.summary() for n, h in sorted(hists.items())},
        })
        snap.raw_samples = {n: h.sample_state() for n, h in hists.items()}
        return snap


# ---------------------------------------------------------------------------
# no-op twins (Telemetry.disabled(): the hot path pays a method call)
# ---------------------------------------------------------------------------

class _NullCounter:
    __slots__ = ()
    name = "null"
    value = 0

    def inc(self, n: int = 1) -> None:
        pass


class _NullGauge:
    __slots__ = ()
    name = "null"
    value = 0.0

    def set(self, v: float) -> None:
        pass


class _NullHistogram:
    __slots__ = ()
    name = "null"
    count = 0
    total = 0.0
    min = None
    max = None
    mean = None

    def observe(self, v: float) -> None:
        pass

    def quantile(self, q: float) -> None:
        return None

    def summary(self) -> dict:
        return {"count": 0, "sum": 0.0, "mean": None, "min": None,
                "max": None, "p50": None, "p95": None, "p99": None}


_NULL_COUNTER = _NullCounter()
_NULL_GAUGE = _NullGauge()
_NULL_HISTOGRAM = _NullHistogram()


class NullRegistry:
    """Registry twin whose instruments are shared no-op singletons."""

    def counter(self, name: str) -> _NullCounter:
        return _NULL_COUNTER

    def gauge(self, name: str) -> _NullGauge:
        return _NULL_GAUGE

    def histogram(self, name: str, max_samples: int = 4096) -> _NullHistogram:
        return _NULL_HISTOGRAM

    def snapshot(self) -> Snapshot:
        return Snapshot({"counters": {}, "gauges": {}, "histograms": {}})


NULL_REGISTRY = NullRegistry()


class StatsView(Mapping):
    """Read-only mapping over live metric sources — the backward-
    compatible face of the serve layer's historical ``stats`` dicts.

    Sources may be `Counter`s (read as ints), callables (evaluated on
    access), or any other object (returned as-is; the bounded
    ``admitted`` / ``occupancy`` observability logs stay deques)."""

    __slots__ = ("_sources",)

    def __init__(self, sources: dict):
        self._sources = sources

    def __getitem__(self, key: str):
        src = self._sources[key]
        if isinstance(src, (Counter, _NullCounter)):
            return src.value
        if callable(src):
            return src()
        return src

    def __iter__(self) -> Iterator[str]:
        return iter(self._sources)

    def __len__(self) -> int:
        return len(self._sources)

    def as_dict(self) -> dict:
        return {k: self[k] for k in self}

    def __repr__(self) -> str:
        return f"StatsView({self.as_dict()!r})"
