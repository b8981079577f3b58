"""Elastic serving capacity: `ElasticAdmission` resizes a serving
shard's concurrency limit (`max_inflight`) from observed queue depth
and recent fused-wave occupancy — the per-shard controller behind
`ServeRuntime(..., elastic=True)`.  Deterministic and lock-free: the
runtime calls `observe` under its own admission lock, so the controller
is plain state + policy.

The port's own copy of `repro.runtime.elastic`'s `ElasticPolicy` and
`ElasticAdmission` (pure Python).  The reference's `ElasticMesh`
rebuilds a JAX device mesh for the LM stack and is not ported here.
"""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class ElasticPolicy:
    """Tuning knobs for `ElasticAdmission`.

    ceiling          hard upper bound on the shard's concurrency limit
                     (the configured `max_inflight` — never exceeded).
    floor            lower bound the limit decays toward when idle.
    step_up          slots added per grow decision (backlog present,
                     every current slot busy, occupancy healthy).
    step_down        slots removed per shrink decision (no backlog and
                     spare slots).
    occupancy_floor  minimum recent fused-wave occupancy for growing:
                     adding workers to a shard whose barrier rounds are
                     already running half-empty only dilutes them.  A
                     shard with no occupancy signal yet (unfused, or no
                     round dispatched) is allowed to grow.
    """
    ceiling: int = 8
    floor: int = 1
    step_up: int = 1
    step_down: int = 1
    occupancy_floor: float = 0.5

    def __post_init__(self):
        if not (1 <= self.floor <= self.ceiling):
            raise ValueError(
                f"need 1 <= floor ({self.floor}) <= ceiling "
                f"({self.ceiling})")
        if self.step_up < 1 or self.step_down < 1:
            raise ValueError("step_up and step_down must be >= 1")


class ElasticAdmission:
    """Queue-depth + occupancy driven `max_inflight` controller.

    One instance per `EngineShard`.  The serving router consults
    `limit` on every admission and calls `observe` at the two points
    where shard pressure changes: when admission stalls with work still
    queued (a grow opportunity) and when a worker finishes with the
    queue empty (a shrink opportunity).  `high_water` records the
    largest limit ever granted — the burst tests pin it against the
    ceiling.
    """

    def __init__(self, policy: Optional[ElasticPolicy] = None):
        self.policy = policy if policy is not None else ElasticPolicy()
        self._limit = self.policy.floor
        self.high_water = self._limit
        self.grows = 0
        self.shrinks = 0

    @property
    def limit(self) -> int:
        return self._limit

    def observe(self, queue_depth: int, inflight: int,
                occupancy: Optional[float] = None) -> bool:
        """One controller step; returns True if the limit changed.

        Grow when there is a backlog, every granted slot is busy, and
        the occupancy signal (when present) clears the policy floor.
        Shrink toward max(floor, inflight) when the queue is empty and
        slots sit idle — the limit never cuts below work already
        running."""
        p = self.policy
        if queue_depth > 0 and inflight >= self._limit:
            if occupancy is not None and occupancy < p.occupancy_floor:
                return False
            new = min(p.ceiling, self._limit + p.step_up)
            if new != self._limit:
                self._limit = new
                self.high_water = max(self.high_water, new)
                self.grows += 1
                return True
            return False
        if queue_depth == 0 and inflight < self._limit:
            new = max(p.floor, inflight, self._limit - p.step_down)
            if new != self._limit:
                self._limit = new
                self.shrinks += 1
                return True
        return False
