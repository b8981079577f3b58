"""SLO targets + the evaluator over metric-snapshot deltas.  The port's
own copy of `repro.sim.slo`, over `repro_torch.obs` snapshots.

`evaluate` is runner-agnostic: it consumes, per phase, a
`Snapshot.diff` delta (exact interval quantiles of
`serve.request_latency_s` / `serve.queue_wait_s`) and the client-side
outcome tally (`clients.outcome_counts`), and emits a JSON-able report:

  * measured columns per phase — p50_s, p99_s, queue_wait_p99_s,
    abandon_rate (1 − done/attempts: timeouts, abandons and failures
    all count against the operator), goodput_rps (deadline-met
    completions per virtual second);
  * one check per configured target, and a phase / scenario verdict.

Latency targets on a phase with zero completed requests pass vacuously
(value None) — the abandon-rate and goodput checks are the ones that
catch a runtime serving nothing.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.sim import clients

LATENCY_HIST = "serve.request_latency_s"
QUEUE_WAIT_HIST = "serve.queue_wait_s"


@dataclasses.dataclass(frozen=True)
class SLOTargets:
    """Operator promises; None disables a check.  Latency/abandon are
    upper bounds, goodput a lower bound."""
    p50_s: Optional[float] = None
    p99_s: Optional[float] = None
    queue_wait_p99_s: Optional[float] = None
    abandon_rate: Optional[float] = None
    goodput_rps: Optional[float] = None


def _hist_q(delta, name: str, q: str) -> Optional[float]:
    h = delta.get("histograms", {}).get(name)
    return None if h is None else h.get(q)


def measures(delta, outcomes: dict, duration_s: float) -> dict:
    """The measured SLO columns for one window."""
    attempts = outcomes.get("attempts", 0)
    done = outcomes.get(clients.DONE, 0)
    rate = 0.0 if attempts == 0 else 1.0 - done / attempts
    return {
        "requests": attempts,
        "done": done,
        "timeout": outcomes.get(clients.TIMEOUT, 0),
        "abandoned": outcomes.get(clients.ABANDONED, 0),
        "failed": outcomes.get(clients.FAILED, 0),
        "p50_s": _hist_q(delta, LATENCY_HIST, "p50"),
        "p99_s": _hist_q(delta, LATENCY_HIST, "p99"),
        "queue_wait_p99_s": _hist_q(delta, QUEUE_WAIT_HIST, "p99"),
        "abandon_rate": round(rate, 6),
        "goodput_rps": round(done / duration_s, 6) if duration_s > 0
        else 0.0,
    }


def _checks(slo: SLOTargets, m: dict) -> list:
    out = []

    def check(metric, limit, value, kind):
        if limit is None:
            return
        if value is None:                     # no samples: vacuous pass
            ok = True
        elif kind == "max":
            ok = value <= limit
        else:
            ok = value >= limit
        out.append({"metric": metric, "kind": kind, "limit": limit,
                    "value": value, "ok": ok})

    check("p50_s", slo.p50_s, m["p50_s"], "max")
    check("p99_s", slo.p99_s, m["p99_s"], "max")
    check("queue_wait_p99_s", slo.queue_wait_p99_s,
          m["queue_wait_p99_s"], "max")
    check("abandon_rate", slo.abandon_rate, m["abandon_rate"], "max")
    check("goodput_rps", slo.goodput_rps, m["goodput_rps"], "min")
    return out


def evaluate(scenario, phase_windows: list, overall_delta,
             overall_outcomes: dict, runner: str) -> dict:
    """Build the scenario report.

    phase_windows: [(phase_name, duration_s, delta_snapshot, outcomes)]
    in order; overall_* cover the whole run (including post-cutoff
    drain), so the headline columns never lose spillover completions.
    """
    phases = []
    for name, dur, delta, outcomes in phase_windows:
        m = measures(delta, outcomes, dur)
        checks = _checks(scenario.slo, m)
        phases.append({"phase": name, "duration_s": dur, **m,
                       "checks": checks,
                       "ok": all(c["ok"] for c in checks)})
    overall = measures(overall_delta, overall_outcomes,
                       scenario.duration_s)
    overall_checks = _checks(scenario.slo, overall)
    ok = all(p["ok"] for p in phases) and all(
        c["ok"] for c in overall_checks)
    return {
        "scenario": scenario.name,
        "runner": runner,
        "seed": scenario.seed,
        "duration_s": scenario.duration_s,
        "population": scenario.population,
        "deadline_s": scenario.deadline_s,
        "ok": ok,
        "expect_ok": scenario.expect_ok,
        "as_expected": ok == scenario.expect_ok,
        "overall": {**overall, "checks": overall_checks},
        "phases": phases,
    }
