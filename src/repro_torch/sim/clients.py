"""Client-population state machine for the traffic simulator.  The
port's own copy of `repro.sim.clients`.

Every request a simulated client makes walks one life cycle::

    IDLE ──▶ SUBMIT ──▶ WAITING ──▶ DONE        completed within deadline
                │           ├─────▶ TIMEOUT     completed, but past its
                │           │                   deadline (server had
                │           │                   already started it, so
                │           │                   `abandon()` returned False)
                │           └─────▶ ABANDONED   client walked away while
                │                               the request was queued
                │                               (deadline expiry, runtime
                │                               shutdown) — no result
                └─────────────────▶ FAILED      rejected at submit or the
                                                server errored

Transitions are validated (`ClientRequest.transition` raises on an edge
not in `_EDGES`), which is what the state-machine coverage tests pin.
Both runners — the real wall-clock driver and the deterministic
virtual-time simulator — produce these records, so SLO evaluation is
runner-agnostic: abandon rate and goodput come from outcome counts,
latency quantiles from the metrics snapshots.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

# life-cycle states
IDLE = "IDLE"
SUBMIT = "SUBMIT"
WAITING = "WAITING"
DONE = "DONE"
TIMEOUT = "TIMEOUT"
ABANDONED = "ABANDONED"
FAILED = "FAILED"

TERMINAL = frozenset({DONE, TIMEOUT, ABANDONED, FAILED})

_EDGES = {
    IDLE: frozenset({SUBMIT}),
    SUBMIT: frozenset({WAITING, FAILED, ABANDONED}),
    WAITING: frozenset({DONE, TIMEOUT, ABANDONED, FAILED}),
}


@dataclasses.dataclass
class ClientRequest:
    """One request's life-cycle record on the VIRTUAL clock.

    `arrival_s` is when the client decided to submit; `deadline_s` the
    absolute virtual time after which the client no longer wants the
    answer; `finish_s` when it reached a terminal state.  `ok_payload`
    is the decrypted-result check (None when validation was skipped)."""
    client_id: str
    workload: str
    arrival_s: float
    deadline_s: float
    state: str = IDLE
    finish_s: Optional[float] = None
    ok_payload: Optional[bool] = None

    def transition(self, new_state: str, at_s: Optional[float] = None):
        allowed = _EDGES.get(self.state, frozenset())
        if new_state not in allowed:
            raise ValueError(
                f"invalid client transition {self.state} -> {new_state} "
                f"(allowed: {sorted(allowed) or 'none — terminal state'})")
        self.state = new_state
        if new_state in TERMINAL:
            self.finish_s = at_s
        return self

    @property
    def latency_s(self) -> Optional[float]:
        if self.finish_s is None:
            return None
        return self.finish_s - self.arrival_s


def outcome_counts(requests: list) -> dict:
    """Terminal-state tally for a batch of ClientRequests.  `attempts`
    counts every request that reached a terminal state; non-terminal
    records (still in flight when the scenario was cut off) are ignored
    — the runners drain before tallying, so normally there are none."""
    counts = {DONE: 0, TIMEOUT: 0, ABANDONED: 0, FAILED: 0}
    for r in requests:
        if r.state in counts:
            counts[r.state] += 1
    counts["attempts"] = sum(counts[s] for s in TERMINAL)
    return counts
