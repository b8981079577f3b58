"""Seeded arrival processes on a virtual clock.  The port's own copy of
`repro.sim.arrivals` (pure Python; the streams equal the reference's).

Every process is a declarative spec; `schedule(duration_s, seed)` expands
an OPEN-LOOP spec into the sorted list of virtual arrival times — a pure
function of (spec, duration, seed), so the same scenario always replays
the same traffic (the simulator's determinism contract pins this in
the tests).

  Poisson     constant-rate open loop: exponential inter-arrival gaps.
  MMPP        Markov-modulated Poisson: the rate steps through declared
              (rate, duration) segments — bursts and ramps — cycling
              until the scenario ends.
  ClosedLoop  think-time pacing: each client submits, waits for its
              result (or abandons at its deadline), thinks, repeats.
              No global pre-schedule exists — arrivals depend on service
              times — so the runners drive it per client; `think(rng)`
              samples the gap.
"""
from __future__ import annotations

import dataclasses
import hashlib
import random


def seeded_rng(*parts) -> random.Random:
    """A `random.Random` seeded from a stable digest of `parts`.

    `random.Random(tuple)` seeds via `hash()`, which Python randomizes
    per process for strings — reports would silently differ across
    processes.  Hashing the repr through sha256 keeps every stream a
    pure function of its labels, which the determinism contract needs."""
    digest = hashlib.sha256(repr(parts).encode()).digest()
    return random.Random(int.from_bytes(digest[:8], "big"))


@dataclasses.dataclass(frozen=True)
class Poisson:
    """Open-loop Poisson arrivals at `rate` requests per virtual second."""
    rate: float

    open_loop = True

    def schedule(self, duration_s: float, seed: int) -> list:
        rng = seeded_rng("poisson", seed, self.rate)
        out, t = [], 0.0
        while True:
            t += rng.expovariate(self.rate)
            if t >= duration_s:
                return out
            out.append(t)


@dataclasses.dataclass(frozen=True)
class MMPP:
    """Markov-modulated Poisson process: rate steps through `segments`
    — a tuple of (rate_rps, duration_s) — cycling until the scenario
    duration is exhausted.  A two-segment (calm, burst) spec is the
    classic bursty workload; a longer ladder is a ramp."""
    segments: tuple                    # ((rate, duration), ...)

    open_loop = True

    def schedule(self, duration_s: float, seed: int) -> list:
        rng = seeded_rng("mmpp", seed, self.segments)
        out, t, seg = [], 0.0, 0
        seg_end = self.segments[0][1]
        while t < duration_s:
            rate = self.segments[seg % len(self.segments)][0]
            gap = rng.expovariate(rate) if rate > 0 else float("inf")
            if t + gap >= seg_end:
                # no arrival before the segment flips: jump to the next
                # rate segment and resample from there
                t = seg_end
                seg += 1
                seg_end += self.segments[seg % len(self.segments)][1]
                continue
            t += gap
            if t >= duration_s:
                break
            out.append(t)
        return out


@dataclasses.dataclass(frozen=True)
class ClosedLoop:
    """Closed-loop think-time pacing: each client owns one outstanding
    request at a time and waits `think` seconds between them.
    `initial_stagger` spreads the population's first submissions so the
    opening instant is not a synchronized thundering herd."""
    think_s: float
    initial_stagger_s: float = 0.5

    open_loop = False

    def think(self, rng: random.Random) -> float:
        return rng.expovariate(1.0 / self.think_s) if self.think_s > 0 \
            else 0.0

    def first_arrival(self, client_idx: int, rng: random.Random) -> float:
        return rng.uniform(0.0, self.initial_stagger_s) \
            if self.initial_stagger_s > 0 else 0.0


def arrival_plan(process, population: int, duration_s: float,
                 seed: int) -> list:
    """Expand an OPEN-LOOP process into [(virtual_time, client_idx)],
    clients assigned round-robin so every simulated tenant participates.
    Closed-loop processes have no global plan (arrivals depend on
    completions) — the runners pace those per client."""
    assert process.open_loop, "closed-loop arrivals are paced per client"
    times = process.schedule(duration_s, seed)
    return [(t, i % population) for i, t in enumerate(times)]
