"""The port's traffic simulator (`repro_torch.sim`) against `repro.sim`.

The pure-Python layers are held to the reference exactly: arrival plans,
the client state machine, workload draws, graphs and oracles, and the
virtual runner's reports, field for field, for the standard suite and
the reference tests' synthetic scenarios.  The wall-clock runner drives
the port's `ServeRuntime` on the `ctx_2bit` keys (carried across with
`interop.context_from_numpy`; the kernels run their plain versions on
the CPU): every DONE payload must decrypt to its integer oracle.  Those
runs drain and give every request a deadline far beyond the CPU's
latency, so no outcome depends on timing.  Tolerance: exact.
"""
import dataclasses
import json
import random

import pytest

torch = pytest.importorskip("torch")

from repro import sim as jsim  # noqa: E402
from repro.sim import runner as jrunner  # noqa: E402
from repro_torch import sim  # noqa: E402
from repro_torch.core.engine import TaurusEngine  # noqa: E402
from repro_torch.sim import runner, suite  # noqa: E402
from test_torch_api import assert_same_graph, port_context  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401


@pytest.fixture(scope="module")
def tctx_2bit(ctx_2bit):
    return port_context(ctx_2bit)


@pytest.fixture(scope="module")
def engine_2bit_port(tctx_2bit):
    return TaurusEngine.from_context(tctx_2bit, device="cpu")


# --- arrivals ------------------------------------------------------------------------

PROCESSES = {
    "poisson": lambda m: m.Poisson(3.0),
    "mmpp": lambda m: m.MMPP(((0.5, 4.0), (8.0, 3.0), (0.0, 1.0))),
}


@pytest.mark.parametrize("seed", [0, 4, 21])
@pytest.mark.parametrize("proc", sorted(PROCESSES))
def test_arrival_plan_equals_reference(proc, seed):
    got = sim.arrival_plan(PROCESSES[proc](sim), 3, 30.0, seed)
    assert got == jsim.arrival_plan(PROCESSES[proc](jsim), 3, 30.0, seed)
    assert len(got) > 10 and got == sorted(got)


@pytest.mark.parametrize("seed", [0, 4, 21])
def test_closed_loop_streams_equal_reference(seed):
    """ClosedLoop has no global plan: its per-client first arrivals and
    think times, drawn from `seeded_rng`, equal the reference's."""
    mine, ref = sim.ClosedLoop(0.7, 0.5), jsim.ClosedLoop(0.7, 0.5)
    r1, r2 = sim.seeded_rng("client", seed, 1), jsim.seeded_rng("client", seed, 1)
    got = [mine.first_arrival(1, r1)] + [mine.think(r1) for _ in range(20)]
    want = [ref.first_arrival(1, r2)] + [ref.think(r2) for _ in range(20)]
    assert got == want
    with pytest.raises(AssertionError):
        sim.arrival_plan(mine, 2, 10.0, seed)


# --- the client state machine --------------------------------------------------------

STATES = ["IDLE", "SUBMIT", "WAITING", "DONE", "TIMEOUT", "ABANDONED", "FAILED"]
# a valid path from IDLE to each state
PATHS = {"IDLE": [], "SUBMIT": ["SUBMIT"], "WAITING": ["SUBMIT", "WAITING"],
         "DONE": ["SUBMIT", "WAITING", "DONE"], "TIMEOUT": ["SUBMIT", "WAITING", "TIMEOUT"],
         "ABANDONED": ["SUBMIT", "ABANDONED"], "FAILED": ["SUBMIT", "FAILED"]}


def _edge(mod, start, new):
    r = mod.ClientRequest("c", "w", 0.0, 5.0)
    for s in PATHS[start]:
        r.transition(s, at_s=1.0)
    try:
        r.transition(new, at_s=2.0)
    except ValueError as e:
        return ("rejected", str(e))
    return ("ok", r.state, r.finish_s, r.latency_s)


@pytest.mark.parametrize("new", STATES)
@pytest.mark.parametrize("start", STATES)
def test_state_machine_edge_equals_reference(start, new):
    """Every (state, next state) pair: accepted or rejected, with the same
    message and finish time, as in the reference."""
    got = _edge(sim, start, new)
    assert got == _edge(jsim, start, new)
    valid = {("IDLE", "SUBMIT"), ("SUBMIT", "WAITING"), ("SUBMIT", "FAILED"),
             ("SUBMIT", "ABANDONED"), ("WAITING", "DONE"), ("WAITING", "TIMEOUT"),
             ("WAITING", "ABANDONED"), ("WAITING", "FAILED")}
    assert (got[0] == "ok") == ((start, new) in valid)


def test_outcome_counts_equal_reference():
    def tally(mod):
        recs = []
        for tail in ("DONE", "DONE", "TIMEOUT", "ABANDONED", "FAILED", None):
            r = mod.ClientRequest("c", "w", 0.0, 1.0)
            r.transition("SUBMIT")
            if tail is not None:
                r.transition("WAITING" if tail != "FAILED" else "FAILED", at_s=0.5)
                if tail != "FAILED":
                    r.transition(tail, at_s=0.5)
            recs.append(r)
        return mod.outcome_counts(recs)
    assert tally(sim) == tally(jsim) == {"DONE": 2, "TIMEOUT": 1, "ABANDONED": 1,
                                         "FAILED": 1, "attempts": 5}


# --- workloads -------------------------------------------------------------------------

def _spec_key(s):
    return (type(s).__name__, dataclasses.astuple(s))


@pytest.mark.parametrize("name", sorted(sim.REGISTRY))
def test_registry_workload_equals_reference(name):
    """Same graph node for node, same specs, same draws from one seed and
    the same oracle values."""
    kw = {"bits": 8, "msg_bits": 2} if name != "gpt2_block" else {}
    w, jw = sim.REGISTRY[name](**kw), jsim.REGISTRY[name](**kw)
    (g, ins, outs), (jg, jins, jouts) = w.build(), jw.build()
    assert_same_graph(g, jg)
    assert [_spec_key(s) for s in ins] == [_spec_key(s) for s in jins]
    assert [_spec_key(s) for s in outs] == [_spec_key(s) for s in jouts]
    assert (w.name, w.mean_service_s) == (jw.name, jw.mean_service_s)
    r1, r2 = random.Random(5), random.Random(5)
    for _ in range(8):
        vals = w.sample_values(r1)
        assert vals == jw.sample_values(r2)
        assert w.oracle(vals) == jw.oracle(vals)


def test_workload_mix_draws_equal_reference():
    kw = {"bits": 8, "msg_bits": 2}
    weights = {"analytics_const": 3.0, "radix_add": 2.0, "radix_mul": 1.0,
               "analytics_linear": 1.0}
    mix, jmix = sim.WorkloadMix.of(weights, **kw), jsim.WorkloadMix.of(weights, **kw)
    r1, r2 = random.Random(9), random.Random(9)
    assert [mix.sample(r1).name for _ in range(300)] == \
        [jmix.sample(r2).name for _ in range(300)]
    with pytest.raises(ValueError):
        sim.WorkloadMix([])


# --- the virtual runner ----------------------------------------------------------------

def _synthetic(mod, service_s):
    return mod.Workload("syn", builder=lambda: (None, (), ()),
                        sample=lambda rng: [], mean_service_s=service_s)


def _scenario(mod, service_s, *, rate=2.0, duration=10.0, deadline=5.0, drain=True,
              seed=0, phases=(), arrival=None, population=4):
    mix = mod.WorkloadMix([(_synthetic(mod, service_s), 1.0)])
    return mod.Scenario("t", arrival or mod.Poisson(rate), mix, duration,
                        population=population, deadline_s=deadline, drain=drain,
                        seed=seed, phases=tuple(mod.Phase(*p) for p in phases),
                        slo=mod.SLOTargets(abandon_rate=0.99))


# the reference tests' synthetic scenarios: (scenario kwargs, max_inflight)
SYNTHETIC = {
    "all_done": (dict(service_s=0.2, deadline=5.0), 8),
    "timeout": (dict(service_s=3.0, rate=0.2, deadline=1.0), 8),
    "abandoned": (dict(service_s=4.0, rate=3.0, deadline=2.0), 1),
    "fail_fast": (dict(service_s=2.0, rate=4.0, duration=6.0, deadline=50.0,
                       drain=False), 1),
    "mmpp_phases": (dict(service_s=0.8, duration=12.0, deadline=4.0, seed=21,
                         arrival="mmpp", phases=(("calm", 4.0), ("burst", 4.0),
                                                 ("recover", 4.0))), 2),
    "closed_loop": (dict(service_s=1.0, duration=20.0, deadline=10.0, seed=3,
                         arrival="closed", population=2), 8),
}


def _make_synthetic(mod, name):
    kw, k = SYNTHETIC[name]
    kw = dict(kw)
    if kw.get("arrival") == "mmpp":
        kw["arrival"] = mod.MMPP(((1.0, 4.0), (6.0, 4.0), (1.0, 4.0)))
    elif kw.get("arrival") == "closed":
        kw["arrival"] = mod.ClosedLoop(think_s=0.5)
    service_s = kw.pop("service_s")
    return _scenario(mod, service_s, **kw), k


def _records(run):
    return [(r.req_id, r.client_id, r.record.state, r.record.arrival_s,
             r.record.deadline_s, r.record.finish_s) for r in run.records]


@pytest.mark.parametrize("name", sorted(SYNTHETIC))
def test_simulate_synthetic_equals_reference(name):
    sc, k = _make_synthetic(sim, name)
    jsc, _ = _make_synthetic(jsim, name)
    got, want = sim.simulate_scenario(sc, max_inflight=k), \
        jsim.simulate_scenario(jsc, max_inflight=k)
    assert got.report == want.report
    assert json.dumps(got.report, sort_keys=True) == json.dumps(want.report, sort_keys=True)
    assert _records(got) == _records(want)
    assert got.report == sim.simulate_scenario(sc, max_inflight=k).report


@pytest.mark.parametrize("idx", range(5))
def test_simulate_standard_suite_equals_reference(idx):
    """The five standard scenarios (steady, burst, overload, mixed_tenant,
    closed_loop) give the reference's report, field for field, and the
    same request plan: the same workloads and values at the same times."""
    sc = sim.standard_suite(capacity_rps=2.0, duration_s=18.0)[idx]
    jsc = jsim.standard_suite(capacity_rps=2.0, duration_s=18.0)[idx]
    assert sc.name == jsc.name == ["steady", "burst", "overload", "mixed_tenant",
                                   "closed_loop"][idx]
    got, want = sim.simulate_scenario(sc), jsim.simulate_scenario(jsc)
    assert got.report == want.report
    assert _records(got) == _records(want)
    if sc.arrival.open_loop:
        mine, ref = runner._open_loop_requests(sc), jrunner._open_loop_requests(jsc)
        assert [(r.workload.name, r.values, r.record.arrival_s) for r in mine] == \
            [(r.workload.name, r.values, r.record.arrival_s) for r in ref]


def test_scenario_phase_duration_mismatch_rejected():
    mix = sim.WorkloadMix([(_synthetic(sim, 1.0), 1.0)])
    with pytest.raises(ValueError, match="phase durations sum"):
        sim.Scenario("bad", sim.Poisson(1.0), mix, duration_s=10.0,
                     phases=(sim.Phase("a", 3.0), sim.Phase("b", 3.0)))


# --- the wall-clock runner on the port's runtime ----------------------------------

def _real(sc, tctx, engine, **kw):
    run = sim.run_scenario(sc, tctx, engine, validate=True, **kw)
    plan = sim.arrival_plan(sc.arrival, sc.population, sc.duration_s, sc.seed)
    o = run.report["overall"]
    assert run.report["runner"] == "real"
    assert o["requests"] == o["done"] == len(run.records) == len(plan) >= 2
    assert all(r.record.state == sim.DONE and r.record.ok_payload for r in run.records)
    assert o["p50_s"] is not None and o["p99_s"] is not None
    return run


def test_run_scenario_pbs_free_decrypts(tctx_2bit, engine_2bit_port):
    """Const-op analytics (zero PBS) through the port's runtime: every
    payload decrypts to its oracle."""
    from repro_torch.api.session import trace_program
    from repro_torch.api.tracing import IntSpec
    bits, msg, mod = 4, 1, 16

    def builder():
        prog = trace_program(lambda x: x * 2 + 1, (IntSpec(bits, msg),))
        return prog.graph, prog.in_specs, prog.out_specs

    w = sim.Workload("const4", builder, sample=lambda rng: [rng.randrange(mod)],
                     oracle=lambda v: [(2 * v[0] + 1) % mod], mean_service_s=0.01)
    sc = sim.Scenario("real_smoke", sim.Poisson(4.0), sim.WorkloadMix([(w, 1.0)]),
                      duration_s=1.5, deadline_s=600.0, population=2,
                      slo=sim.SLOTargets(abandon_rate=0.0, goodput_rps=0.5), seed=5)
    run = _real(sc, tctx_2bit, engine_2bit_port, max_inflight=2)
    assert run.report["ok"] and run.report["as_expected"]
    assert run.report["shards"] == 1 and run.report["max_inflight"] == 2


def test_run_scenario_radix_add_decrypts(tctx_2bit, engine_2bit_port):
    """radix_add (4-bit integers of 1-bit digits, PBS carry rounds) and
    const-op analytics mixed, on two shards over one engine's key: every
    DONE payload decrypts to its integer oracle."""
    mix = sim.WorkloadMix.of({"radix_add": 2.0, "analytics_const": 1.0},
                             bits=4, msg_bits=1)
    sc = sim.Scenario("real_add", sim.Poisson(3.0), mix, duration_s=1.5,
                      deadline_s=600.0, population=3, seed=2)
    run = _real(sc, tctx_2bit, engine_2bit_port, max_inflight=3, shards=2)
    assert run.report["shards"] == 2
    assert {r.workload.name for r in run.records} == {"radix_add", "analytics_const"}


def test_run_suite_on_the_cpu(tctx_2bit, engine_2bit_port, tmp_path):
    """`sim.suite.run_suite` end to end at a short duration: the capacity
    anchor in its clamp, the virtual reports deterministic, every DONE
    payload checked (a wrong one raises), every record terminal, and the
    rows written with the reference benchmark's columns."""
    out = tmp_path / "sim.json"
    res = suite.run_suite(tctx_2bit, engine_2bit_port, duration_s=2.0, bits=4,
                          msg_bits=1, out=out)
    assert 0.4 <= res["capacity_rps"] <= 4.0 and res["virtual_deterministic"]
    rows = res["rows"]
    assert [r["scenario"] for r in rows] == ["steady", "burst", "overload",
                                            "mixed_tenant", "closed_loop"]
    for r in rows:
        assert set(suite.BENCH_COLUMNS) <= set(r)
        assert r["virtual_deterministic"]
        assert r["requests"] == r["records"] == \
            r["done"] + r["timeout"] + r["abandoned"] + r["failed"]
        assert r["payloads_ok"] == r["done"]
    assert json.loads(out.read_text())["rows"] == json.loads(json.dumps(rows))
