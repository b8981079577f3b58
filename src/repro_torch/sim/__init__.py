"""repro_torch.sim — stochastic traffic simulation + SLO harness for the
port's FHE serving stack: the port of `repro.sim` (same names, reports
equal field for field; nothing here imports JAX or `repro`).

Capacity questions ("what does p99 do when a burst doubles the arrival
rate?", "how many tenants before clients start abandoning?") need
repeatable traffic, not ad-hoc scripts.  This package provides:

  arrivals    seeded arrival processes on a virtual clock — Poisson,
              bursty/ramp MMPP, closed-loop think-time.
  clients     the client-population state machine (IDLE → SUBMIT →
              WAITING → DONE / TIMEOUT / ABANDONED / FAILED) with
              validated transitions and per-request deadlines.
  workloads   weighted mixes over the existing program builders: radix
              arithmetic, const-op analytics (zero PBS), radix_linear
              queries, the GPT-2 block.
  scenario    declarative `Scenario` (population, phases, arrival
              process, workload mix, SLO targets) + `standard_suite`.
  slo         `SLOTargets` and the runner-agnostic evaluator over
              `Snapshot.diff` metric windows.
  runner      `run_scenario` (real ciphertexts on a real `ServeRuntime`,
              wall clock) and `simulate_scenario` (deterministic
              discrete-event replay in virtual time — same scenario,
              same seed ⇒ identical report, field for field).

Example::

    from repro_torch.sim import (Poisson, Scenario, SLOTargets,
                                 WorkloadMix, simulate_scenario)
    mix = WorkloadMix.of({"radix_add": 1.0}, bits=8, msg_bits=2)
    sc = Scenario("steady", Poisson(2.0), mix, duration_s=30.0,
                  deadline_s=6.0, slo=SLOTargets(p99_s=5.0))
    run = simulate_scenario(sc, max_inflight=4)
    assert run.report["ok"]

`python -m repro_torch.sim.suite` runs `standard_suite` end-to-end on
real ciphertexts on the card and writes its rows to
`build/sim_slo_torch.json`.
"""
from repro_torch.sim.arrivals import (ClosedLoop, MMPP, Poisson, arrival_plan,
                                      seeded_rng)
from repro_torch.sim.clients import (ABANDONED, DONE, FAILED, IDLE, SUBMIT,
                                     TIMEOUT, WAITING, ClientRequest,
                                     outcome_counts)
from repro_torch.sim.runner import (ScenarioRun, SimRequest,
                                    default_service_model, run_scenario,
                                    simulate_scenario)
from repro_torch.sim.scenario import Phase, Scenario, standard_suite
from repro_torch.sim.slo import SLOTargets, evaluate, measures
from repro_torch.sim.workloads import REGISTRY, Workload, WorkloadMix

__all__ = [
    "ABANDONED", "DONE", "FAILED", "IDLE", "SUBMIT", "TIMEOUT", "WAITING",
    "ClientRequest", "ClosedLoop", "MMPP", "Phase", "Poisson", "REGISTRY",
    "Scenario", "ScenarioRun", "SimRequest", "SLOTargets", "Workload",
    "WorkloadMix", "arrival_plan", "default_service_model", "evaluate",
    "measures", "outcome_counts", "run_scenario", "seeded_rng",
    "simulate_scenario", "standard_suite",
]
