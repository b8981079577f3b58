"""Declarative traffic scenarios + the standard SLO suite.  The port's
own copy of `repro.sim.scenario`.

A `Scenario` is pure data: who arrives (arrival process over a client
population), what they run (a `WorkloadMix`), how patient they are
(`deadline_s`), for how long (phases on the virtual clock), and what
the operator promised (`SLOTargets`).  Both runners consume the same
object — `run_scenario` paces it onto a real `ServeRuntime` on the wall
clock, `simulate_scenario` replays it deterministically in virtual time
— and `slo.evaluate` turns either run's per-phase metric deltas into
the pass/fail report.
"""
from __future__ import annotations

import dataclasses

from repro_torch.sim.arrivals import ClosedLoop, MMPP, Poisson
from repro_torch.sim.slo import SLOTargets
from repro_torch.sim.workloads import WorkloadMix


@dataclasses.dataclass(frozen=True)
class Phase:
    """One evaluation window: metrics snapshots are taken at phase
    boundaries and diffed, so each phase gets its own SLO verdict."""
    name: str
    duration_s: float


@dataclasses.dataclass(frozen=True)
class Scenario:
    name: str
    arrival: object                     # Poisson | MMPP | ClosedLoop
    mix: WorkloadMix
    duration_s: float
    population: int = 4
    deadline_s: float = 10.0            # per-request patience (relative)
    slo: SLOTargets = dataclasses.field(default_factory=SLOTargets)
    seed: int = 0
    phases: tuple = ()                  # default: one phase, full duration
    drain: bool = True                  # False → close(drain=False) at cut
    expect_ok: bool = True              # documented verdict (overload=False)

    def __post_init__(self):
        if self.phases:
            total = sum(p.duration_s for p in self.phases)
            if abs(total - self.duration_s) > 1e-9:
                raise ValueError(
                    f"scenario {self.name!r}: phase durations sum to "
                    f"{total}, duration_s is {self.duration_s}")

    def phase_list(self) -> list:
        """[(phase, absolute end time)] covering the full duration."""
        phases = self.phases or (Phase("all", self.duration_s),)
        out, t = [], 0.0
        for p in phases:
            t += p.duration_s
            out.append((p, t))
        return out


def standard_suite(capacity_rps: float = 1.0, *, bits: int = 8,
                   msg_bits: int = 2, duration_s: float = 18.0,
                   deadline_s: float = 12.0, seed: int = 7) -> list:
    """The five-scenario SLO suite `repro_torch.sim.suite` runs.

    `capacity_rps` anchors arrival rates to the serving capacity of the
    machine under test (measure one request, divide max_inflight by its
    latency).  Scenarios:

      steady        Poisson at 60% capacity — the SLO-meeting baseline.
      burst         MMPP calm → 2.2x-capacity burst → recovery, one SLO
                    verdict per phase (the burst phase eats the queue).
      overload      Poisson at 3x capacity with tight deadlines: clients
                    abandon queued work, and the scenario ends with
                    `close(drain=False)` — the fail-fast shutdown path.
                    Documented as expect_ok=False: its report SHOULD
                    show the SLO breach.
      mixed_tenant  six tenants interleaving cheap const-op analytics
                    (zero PBS) with PBS-heavy radix arithmetic and
                    linear queries on one runtime.
      closed_loop   think-time pacing: population-bound concurrency,
                    the classic interactive-tenant shape.
    """
    kw = dict(bits=bits, msg_bits=msg_bits)
    arith = WorkloadMix.of({"radix_add": 2.0, "radix_mul": 1.0}, **kw)
    mixed = WorkloadMix.of({"analytics_const": 3.0, "radix_add": 2.0,
                            "radix_mul": 1.0, "analytics_linear": 1.0},
                           **kw)
    cap = capacity_rps
    lenient = SLOTargets(p99_s=deadline_s, queue_wait_p99_s=deadline_s,
                         abandon_rate=0.05, goodput_rps=0.25 * cap)
    third = duration_s / 3.0
    return [
        Scenario("steady", Poisson(0.6 * cap), arith, duration_s,
                 deadline_s=deadline_s, slo=lenient, seed=seed),
        Scenario("burst",
                 MMPP(((0.3 * cap, third), (2.2 * cap, third),
                       (0.3 * cap, third))),
                 arith, duration_s, deadline_s=deadline_s,
                 # the burst phase is SUPPOSED to spike latency (clients
                 # ride out their deadline while the queue drains), so
                 # the latency bound gets 2x headroom — the collapse
                 # detector here is the abandon rate
                 slo=SLOTargets(p99_s=2.0 * deadline_s,
                                abandon_rate=0.25),
                 seed=seed + 1,
                 phases=(Phase("calm", third), Phase("burst", third),
                         Phase("recover", third))),
        Scenario("overload", Poisson(3.0 * cap), arith, duration_s,
                 deadline_s=0.4 * deadline_s,
                 slo=SLOTargets(abandon_rate=0.05,
                                goodput_rps=0.5 * cap),
                 seed=seed + 2, drain=False, expect_ok=False),
        Scenario("mixed_tenant", Poisson(1.0 * cap), mixed, duration_s,
                 population=6, deadline_s=deadline_s,
                 slo=SLOTargets(p99_s=1.5 * deadline_s,
                                abandon_rate=0.10),
                 seed=seed + 3),
        Scenario("closed_loop", ClosedLoop(think_s=1.0 / max(cap, 1e-9)),
                 arith, duration_s, population=3, deadline_s=deadline_s,
                 slo=SLOTargets(p99_s=deadline_s, abandon_rate=0.05),
                 seed=seed + 4),
    ]
