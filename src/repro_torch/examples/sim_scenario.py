"""Traffic simulation and SLO evaluation, narrated, on the port.

    python -m repro_torch.examples.sim_scenario [--device cpu] [--out sim_scenario_report.json]

Builds one bursty scenario (six tenants, an MMPP arrival process that
steps calm -> 2.5x burst -> calm, a mix of cheap const-op analytics and
PBS-heavy radix arithmetic) and runs it twice: `simulate_scenario`, the
deterministic virtual-time replay (run twice, identical field for
field), and `run_scenario`, the same scenario paced onto the wall clock
against a real `ServeRuntime`, every completed payload decrypted and
checked against the workload's integer oracle.  The port of
`examples/sim_scenario.py`.
"""
from __future__ import annotations

import json
import sys

from repro_torch.core.engine import TaurusEngine
from repro_torch.core.params import TEST_PARAMS_4BIT
from repro_torch.core.pbs import TFHEContext
from repro_torch.device import resolve_device
from repro_torch.examples import generator, parser
from repro_torch.sim import (MMPP, Phase, Scenario, SLOTargets, WorkloadMix,
                             run_scenario, simulate_scenario)

THIRD = 4.0


def scenario() -> Scenario:
    mix = WorkloadMix.of({"analytics_const": 2.0, "radix_add": 2.0, "radix_mul": 1.0},
                         bits=8, msg_bits=2)
    return Scenario(
        "bursty_tenants", MMPP(((0.5, THIRD), (2.5, THIRD), (0.5, THIRD))),
        mix, duration_s=3 * THIRD, population=6, deadline_s=10.0,
        slo=SLOTargets(p99_s=20.0, abandon_rate=0.25), seed=42,
        phases=(Phase("calm", THIRD), Phase("burst", THIRD), Phase("recover", THIRD)))


def show(tag, report) -> None:
    o = report["overall"]
    print(f"  [{tag}] requests={o['requests']} done={o['done']} "
          f"timeout={o['timeout']} abandoned={o['abandoned']} "
          f"p99={o['p99_s']} goodput={o['goodput_rps']} rps "
          f"slo={'PASS' if report['ok'] else 'FAIL'}")
    for ph in report["phases"]:
        print(f"    phase {ph['phase']:8s} requests={ph['requests']:3d} "
              f"p99={ph['p99_s']} ok={ph['ok']}")


def main(argv=None) -> int:
    ap = parser(__doc__)
    ap.add_argument("--out", default="sim_scenario_report.json")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    sc = scenario()

    print("== virtual replay (deterministic, no crypto) ==")
    v1 = simulate_scenario(sc, max_inflight=4)
    v2 = simulate_scenario(sc, max_inflight=4)
    assert v1.report == v2.report, "seeded replay must be identical"
    show("virtual", v1.report)
    print("  replayed twice: reports identical field for field")

    print(f"== real runtime (big-key ciphertexts, wall clock, {device}) ==")
    ctx = TFHEContext.create(generator(device, 0), TEST_PARAMS_4BIT, device=device)
    engine = TaurusEngine.from_context(ctx, device=device)
    real = run_scenario(sc, ctx, engine, max_inflight=4, validate=True)
    done = [r for r in real.records if r.record.ok_payload is not None]
    bad = [r.record.client_id for r in done if r.record.ok_payload is False]
    print(f"  decrypted payloads = {len(done) - len(bad)} of {len(done)} correct   "
          f"(expect {len(done)} of {len(done)} correct)")
    assert not bad, f"decrypted payloads diverged from oracle: {bad}"
    show("real", real.report)
    print("  every completed payload decrypted == integer oracle")

    with open(args.out, "w") as f:
        json.dump({"virtual": v1.report, "real": real.report}, f, indent=1, default=float)
    print(f"full reports -> {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
