"""Fault-tolerant step execution: retries, deadlines, checkpoint/restart.
The port's own copy of `repro.runtime.fault` (pure Python).

On a real deployment the failure modes are (a) device/host loss
(the runtime raises), (b) stragglers (step wall-time far beyond the running
median), (c) data corruption (non-finite loss).  `StepRunner` wraps a
compiled step function with:

  * non-finite-loss skip (bad batch is dropped, step retried with the
    next batch — standard large-run hygiene),
  * straggler deadline: steps slower than `straggler_factor` x the
    running median are counted; persistent stragglers trigger a
    re-compile/re-shard callback (reschedule the work),
  * crash recovery: on exception the runner restores the latest
    checkpoint and continues (the training loop's `on_failure` callback).

Everything is observable through `runner.stats`.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

import numpy as np


@dataclasses.dataclass
class FaultConfig:
    max_retries: int = 3
    straggler_factor: float = 3.0
    straggler_patience: int = 5      # consecutive slow steps before action
    checkpoint_every: int = 100


class StepRunner:
    def __init__(self, step_fn: Callable, fault: FaultConfig = FaultConfig(),
                 on_failure: Optional[Callable] = None,
                 on_straggler: Optional[Callable] = None,
                 telemetry=None):
        self.step_fn = step_fn
        self.fault = fault
        self.on_failure = on_failure
        self.on_straggler = on_straggler
        # optional repro_torch.obs.Telemetry: fault.* counters + retry instants
        # land in the same registry/trace as the serve-path spans
        self.telemetry = telemetry
        self.durations: list = []
        self.stats = {"retries": 0, "skipped_nonfinite": 0,
                      "straggler_events": 0, "failures": 0}
        self._slow_streak = 0

    def _count(self, key: str) -> None:
        self.stats[key] += 1
        if self.telemetry is not None:
            self.telemetry.counter(f"fault.{key}").inc()

    def _median(self) -> float:
        if len(self.durations) < 5:
            return float("inf")
        return float(np.median(self.durations[-50:]))

    def run(self, *args, **kwargs):
        """Execute one step with retry + straggler accounting.

        The wrapped step must return (..., metrics) with metrics["loss"]."""
        for attempt in range(self.fault.max_retries + 1):
            t0 = time.monotonic()
            try:
                out = self.step_fn(*args, **kwargs)
            except Exception:
                self._count("failures")
                if attempt >= self.fault.max_retries:
                    raise
                if self.on_failure is not None:
                    args, kwargs = self.on_failure(args, kwargs)
                self._count("retries")
                if self.telemetry is not None:
                    self.telemetry.instant("retry", cat="fault",
                                           attempt=attempt + 1)
                continue
            dt = time.monotonic() - t0
            metrics = out[-1] if isinstance(out, tuple) else None
            loss = metrics.get("loss") if isinstance(metrics, dict) else None
            if loss is not None and not bool(np.isfinite(np.asarray(loss))):
                self._count("skipped_nonfinite")
                return None  # caller advances to the next batch
            med = self._median()
            self.durations.append(dt)
            if dt > self.fault.straggler_factor * med:
                self._slow_streak += 1
                if self._slow_streak >= self.fault.straggler_patience:
                    self._count("straggler_events")
                    self._slow_streak = 0
                    if self.on_straggler is not None:
                        self.on_straggler()
            else:
                self._slow_streak = 0
            return out
        raise RuntimeError("unreachable")
