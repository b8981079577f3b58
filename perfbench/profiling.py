"""The traced segment: `torch.profiler` over a stretch of served load,
read back from its Chrome trace.

`DeviceTrace` holds what the readers need: every device event (kernel,
copy, set) with its name, start, duration and launch grid, the CUDA
runtime calls of the host, the segment's wall, and the device's busy
time (the union of its events' intervals).  The trace file goes to a
temporary directory under TMPDIR and is deleted once read.
"""
from __future__ import annotations

import collections
import dataclasses
import json
import os
import tempfile
import time

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


@dataclasses.dataclass
class DeviceEvent:
    name: str
    ts: float          # microseconds, the trace's clock
    dur: float         # microseconds
    stream: int
    grid: tuple


@dataclasses.dataclass
class DeviceTrace:
    events: list                 # DeviceEvent, sorted by start
    runtime: list                # (name, ts, dur) host CUDA calls
    wall_s: float                # the traced segment's length

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals()) / 1e6

    def busy_intervals(self) -> list:
        out = []
        for e in self.events:
            a, b = e.ts, e.ts + e.dur
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return out

    def device_ops(self, top: int = 10) -> list:
        """[name, seconds] of the device operations that took most time."""
        by = collections.defaultdict(float)
        for e in self.events:
            by[e.name] += e.dur / 1e6
        return [[n[:120], s] for n, s in sorted(by.items(), key=lambda kv: -kv[1])[:top]]

    def idle_gaps(self, top: int = 10) -> list:
        """[what the host was doing, seconds] of the longest gaps between
        device activity: the CUDA call that covers most of the gap, or
        host work with no CUDA call."""
        busy = self.busy_intervals()
        gaps = [(a[1], b[0]) for a, b in zip(busy, busy[1:]) if b[0] > a[1]]
        gaps.sort(key=lambda g: g[0] - g[1])
        out = []
        for g0, g1 in gaps[:top]:
            cover = collections.defaultdict(float)
            for name, ts, dur in self.runtime:
                lo, hi = max(g0, ts), min(g1, ts + dur)
                if hi > lo:
                    cover[name] += hi - lo
            what = max(cover, key=cover.get) if cover else "host work, no CUDA call"
            out.append([what, (g1 - g0) / 1e6])
        return out


class Profiled:
    """Context manager: profile the device and the host's CUDA calls
    while the caller keeps serving; `.trace` afterwards."""

    def __init__(self):
        self.trace = None

    def __enter__(self) -> "Profiled":
        import torch
        from torch.profiler import ProfilerActivity, profile
        torch.cuda.synchronize()
        self._prof = profile(activities=[ProfilerActivity.CUDA])
        self._prof.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        import torch
        torch.cuda.synchronize()
        wall = time.perf_counter() - self._t0
        self._prof.__exit__(*exc)
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "trace.json")
            self._prof.export_chrome_trace(path)
            with open(path) as f:
                raw = json.load(f)["traceEvents"]
        self.trace = parse(raw, wall)


def parse(raw: list, wall_s: float) -> DeviceTrace:
    events, runtime = [], []
    for e in raw:
        cat = e.get("cat")
        if cat in DEVICE_CATS and "dur" in e:
            args = e.get("args", {})
            events.append(DeviceEvent(e["name"], float(e["ts"]), float(e["dur"]),
                                      int(args.get("stream", 0)),
                                      tuple(args.get("grid", ()))))
        elif cat and cat.startswith("cuda_") and "dur" in e:     # host CUDA API calls
            runtime.append((e["name"], float(e["ts"]), float(e["dur"])))
    events.sort(key=lambda e: e.ts)
    return DeviceTrace(events, runtime, wall_s)
