"""The port's `repro_torch.obs` against `repro.obs`, and the serve stack's
accounting through it.

The pure cases (metrics primitives, span tracing and its Chrome export,
the bandwidth ledger, snapshot deltas) run once per package, on the
reference's classes and on the port's copies, with the same literal
expectations, so both give equal results; traces exported by one package
validate under the other's checker.  The serve-stack cases run the port's
`ServeRuntime` and the reference's on the same JAX-encrypted inputs and
compare their counters; tolerance: exact (decrypts, counts, bytes).
"""
import json
import sys
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro import obs as jobs  # noqa: E402
from repro.compiler.ir import trace as jtrace  # noqa: E402
from repro.core.integer import IntegerContext as JaxIntegerContext  # noqa: E402
from repro.runtime.fault import FaultConfig as JaxFaultConfig  # noqa: E402
from repro.serve import ServeRuntime as JaxServeRuntime  # noqa: E402
from repro.serve import encrypt_request_inputs as jax_encrypt  # noqa: E402
from repro.serve import radix_binop_program as jax_binop  # noqa: E402
from repro_torch import obs as tobs  # noqa: E402
from repro_torch.compiler.ir import trace  # noqa: E402
from repro_torch.core.engine import TaurusEngine  # noqa: E402
from repro_torch.core.integer import IntegerContext  # noqa: E402
from repro_torch.core.params import TFHEParams  # noqa: E402
from repro_torch.core.pbs import TFHEContext  # noqa: E402
from repro_torch.interop import u64_to_tensor  # noqa: E402
from repro_torch.runtime.fault import FaultConfig  # noqa: E402
from repro_torch.serve import (ServeRuntime, decrypt_radix_output,  # noqa: E402
                               encrypt_request_inputs, radix_binop_program)
from test_torch_api import port_context  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401

PKGS = {"reference": jobs, "port": tobs}
BITS = 8


# --- metrics primitives ------------------------------------------------------

@pytest.mark.parametrize("pkg", PKGS)
def test_registry_counters_gauges_histograms_snapshot(pkg):
    reg = PKGS[pkg].MetricsRegistry()
    c = reg.counter("requests")
    assert reg.counter("requests") is c            # get-or-create
    c.inc()
    c.inc(4)
    reg.gauge("depth").set(7)
    h = reg.histogram("lat")
    for v in (1.0, 2.0, 3.0, 4.0):
        h.observe(v)
    snap = reg.snapshot()
    assert snap["counters"] == {"requests": 5}
    assert snap["gauges"] == {"depth": 7.0}
    s = snap["histograms"]["lat"]
    assert s["count"] == 4 and s["sum"] == 10.0 and s["mean"] == 2.5
    assert s["min"] == 1.0 and s["max"] == 4.0 and s["p50"] == 3.0


@pytest.mark.parametrize("pkg", PKGS)
def test_counter_concurrent_increments_exact(pkg):
    """Eight threads under a short switch interval lose no increment."""
    c = PKGS[pkg].MetricsRegistry().counter("n")

    def worker():
        for _ in range(5_000):
            c.inc()

    ts = [threading.Thread(target=worker) for _ in range(8)]
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in ts)
    assert c.value == 40_000


def _reservoir(pkg):
    h = PKGS[pkg].Histogram("lat", max_samples=512)
    n = 10_000
    for i in range(n):
        h.observe(i / n)                    # uniform [0, 1)
    return h, n


@pytest.mark.parametrize("pkg", PKGS)
def test_histogram_reservoir_past_cap_stays_calibrated(pkg):
    """count/sum/min/max are exact past the reservoir cap, the quantiles
    track a known distribution, and the seeded reservoir keeps the same
    samples in both packages."""
    h, n = _reservoir(pkg)
    assert h.count == n
    assert h.total == pytest.approx(sum(i / n for i in range(n)))
    assert h.min == 0.0 and h.max == (n - 1) / n
    assert len(h._samples) == 512           # bounded memory
    assert h.quantile(0.50) == pytest.approx(0.5, abs=0.08)
    assert h.quantile(0.99) == pytest.approx(0.99, abs=0.08)
    assert h._samples == _reservoir("reference")[0]._samples


@pytest.mark.parametrize("pkg", PKGS)
def test_stats_view_is_readonly_live_mapping(pkg):
    obs = PKGS[pkg]
    c = obs.MetricsRegistry().counter("done")
    log = [("a", 0)]
    view = obs.StatsView({"done": c, "rate": lambda: 0.5, "admitted": log})
    assert view["done"] == 0
    c.inc(3)
    assert view["done"] == 3                # live, not a copy
    assert view["rate"] == 0.5              # callables evaluated
    assert view["admitted"] is log          # logs pass through
    assert dict(view.as_dict()) == {"done": 3, "rate": 0.5, "admitted": log}
    with pytest.raises(TypeError):
        view["done"] = 9                    # Mapping, not MutableMapping


@pytest.mark.parametrize("pkg", PKGS)
def test_telemetry_defaults_and_disabled(pkg):
    obs = PKGS[pkg]
    tel = obs.Telemetry()                   # serve default: metrics only
    assert not tel.tracing
    tel.counter("c").inc()
    with tel.span("s", cat="t"):
        pass
    assert tel.snapshot()["counters"] == {"c": 1}
    assert tel.chrome_trace()["traceEvents"] == []   # tracing off

    off = obs.Telemetry.disabled()
    off.counter("c").inc(100)
    off.histogram("h").observe(1.0)
    off.bandwidth.account_round(participants=2, rows_logical=1,
                                rows_dispatched=1, rows_padded=0,
                                bsk_bytes=10, ksk_bytes=10)
    snap = off.snapshot()
    assert snap["counters"] == {} and snap["bandwidth"] == {}


# --- span tracing + Chrome export -------------------------------------------

@pytest.mark.parametrize("pkg", PKGS)
def test_trace_recorder_spans_instants_backfill_roundtrip(pkg, tmp_path):
    """Spans, instants and a backfilled interval export to a Chrome trace
    that both packages' validators accept."""
    tel = PKGS[pkg].Telemetry(trace=True)
    t0 = time.perf_counter()
    with tel.span("request", cat="serve", request=0) as sp:
        tel.instant("submit", cat="serve", request=0)
        with tel.span("pbs_round", cat="sched"):
            time.sleep(0.002)
        sp.set(outcome="completed")         # args discovered mid-span
    tel.record("queue_wait", "serve", t0 - 0.01, 0.005, request=0)

    spans = tel.recorder.spans()
    assert sorted(s.name for s in spans) == ["pbs_round", "queue_wait", "request"]
    req = next(s for s in spans if s.name == "request")
    rnd = next(s for s in spans if s.name == "pbs_round")
    assert req.args == {"request": 0, "outcome": "completed"}
    assert req.ts <= rnd.ts and rnd.ts + rnd.dur <= req.ts + req.dur

    obj = tel.chrome_trace()
    n = PKGS[pkg].validate_chrome_trace(obj)
    assert n == PKGS[pkg].validate_chrome_trace(json.dumps(obj))
    path = tel.write_chrome_trace(str(tmp_path / "t.json"))
    for other in PKGS.values():
        assert other.validate_chrome_trace(path) == n
    phs = [e["ph"] for e in obj["traceEvents"]]
    assert phs.count("X") == 3 and phs.count("i") == 1 and "M" in phs


@pytest.mark.parametrize("pkg", PKGS)
def test_validate_chrome_trace_rejects_partial_overlap(pkg):
    validate = PKGS[pkg].validate_chrome_trace

    def ev(name, ts, dur):
        return {"name": name, "ph": "X", "pid": 1, "tid": 0,
                "ts": ts, "dur": dur}

    assert validate({"traceEvents": [ev("a", 0, 10), ev("b", 2, 5)]}) == 2
    with pytest.raises(ValueError, match="partially"):
        validate({"traceEvents": [ev("a", 0, 10), ev("b", 5, 10)]})
    with pytest.raises(ValueError, match="missing"):
        validate({"traceEvents": [{"name": "x", "ph": "i"}]})


# --- bandwidth ledger --------------------------------------------------------

@pytest.mark.parametrize("pkg", PKGS)
def test_bandwidth_ledger_counterfactual_math(pkg):
    led = PKGS[pkg].BandwidthLedger()
    led.account_round(participants=4, rows_logical=16, rows_dispatched=12,
                      rows_padded=4, bsk_bytes=1000, ksk_bytes=100)
    led.account_round(participants=1, rows_logical=4, rows_dispatched=4,
                      rows_padded=0, bsk_bytes=1000, ksk_bytes=100)
    snap = led.snapshot()
    assert snap["bsk_bytes_streamed"] == 2_000
    assert snap["bsk_bytes_unfused"] == 5_000
    assert snap["bsk_bytes_saved"] == 3_000 == led.bsk_bytes_saved
    assert snap["ksk_bytes_saved"] == 300
    assert snap["rows_deduped"] == 4        # dedup is rows, not key bytes
    assert snap["rows_padded"] == 4 and snap["fused_rounds"] == 2
    assert snap == _ledger_snapshot("reference")


def _ledger_snapshot(pkg):
    led = PKGS[pkg].BandwidthLedger()
    led.account_round(participants=4, rows_logical=16, rows_dispatched=12,
                      rows_padded=4, bsk_bytes=1000, ksk_bytes=100)
    led.account_round(participants=1, rows_logical=4, rows_dispatched=4,
                      rows_padded=0, bsk_bytes=1000, ksk_bytes=100)
    return led.snapshot()


def test_engine_key_bytes_reads_the_port_tensors(ctx_2bit, engine_2bit):
    """Before a fused engine holds its pack, the Fourier BSK and the int64
    KSK, as the reference counts them; after, the pack's resident planes
    and KSK limb operand."""
    tctx = port_context(ctx_2bit)
    eng = TaurusEngine.from_context(tctx, device="cpu",
                                    kernel_backend="reference")
    assert tobs.engine_key_bytes(eng) == jobs.engine_key_bytes(engine_2bit)
    fused = TaurusEngine.from_context(tctx, device="cpu")
    assert tobs.engine_key_bytes(fused) == jobs.engine_key_bytes(engine_2bit)
    pack = fused.fused_pack
    assert tobs.engine_key_bytes(fused) == pack.resident_key_bytes == (
        pack.bsk_planes.numel() * 8, pack.ksk_limbs.numel())


# --- Snapshot.diff -----------------------------------------------------------

@pytest.mark.parametrize("pkg", PKGS)
def test_snapshot_diff_counters_gauges_and_exact_interval_quantiles(pkg):
    reg = PKGS[pkg].MetricsRegistry()
    c = reg.counter("serve.completed")
    g = reg.gauge("serve.queue_depth")
    h = reg.histogram("serve.request_latency_s")
    c.inc(3)
    g.set(5)
    for v in (10.0, 20.0):
        h.observe(v)
    earlier = reg.snapshot()
    c.inc(4)
    g.set(2)
    for v in (30.0, 40.0, 50.0, 60.0):
        h.observe(v)
    delta = reg.snapshot().diff(earlier)
    assert delta["counters"]["serve.completed"] == 4
    assert delta["gauges"]["serve.queue_depth"] == 2
    hd = delta["histograms"]["serve.request_latency_s"]
    assert hd["count"] == 4 and hd["sum"] == 180.0 and hd["mean"] == 45.0
    assert hd["min"] == 30.0 and hd["max"] == 60.0
    assert hd["p50"] == 50.0 and hd["p99"] == 60.0
    reg.counter("serve.abandoned").inc(2)
    delta2 = reg.snapshot().diff(earlier)
    assert delta2["counters"]["serve.abandoned"] == 2
    empty = reg.snapshot().diff(reg.snapshot())
    hd0 = empty["histograms"]["serve.request_latency_s"]
    assert hd0["count"] == 0 and hd0["p50"] is None
    json.dumps(delta)


@pytest.mark.parametrize("pkg", PKGS)
def test_snapshot_diff_reservoir_fallback_keeps_exact_counts(pkg):
    reg = PKGS[pkg].MetricsRegistry()
    h = reg.histogram("lat", 64)
    for v in range(10):
        h.observe(float(v))
    earlier = reg.snapshot()
    for v in range(100):                      # blows past the cap of 64
        h.observe(float(v))
    hd = reg.snapshot().diff(earlier)["histograms"]["lat"]
    assert hd["count"] == 100
    assert hd["sum"] == float(sum(range(100)))
    assert hd["p50"] is None and hd["p99"] is None


@pytest.mark.parametrize("pkg", PKGS)
def test_snapshot_diff_bandwidth_and_telemetry_roundtrip(pkg):
    tel = PKGS[pkg].Telemetry()
    tel.counter("serve.admitted").inc(2)
    tel.bandwidth.account_round(participants=2, rows_logical=4,
                                rows_dispatched=3, rows_padded=1,
                                bsk_bytes=1000, ksk_bytes=100)
    earlier = tel.snapshot()
    tel.counter("serve.admitted").inc(5)
    tel.bandwidth.account_round(participants=3, rows_logical=6,
                                rows_dispatched=5, rows_padded=0,
                                bsk_bytes=1000, ksk_bytes=100)
    delta = tel.snapshot().diff(earlier)
    assert delta["counters"]["serve.admitted"] == 5
    assert delta["bandwidth"]["fused_rounds"] == 1
    assert delta["bandwidth"]["participants"] == 3
    assert delta["bandwidth"]["rows_dispatched"] == 5
    assert delta["bandwidth"]["bsk_bytes_streamed"] == 1000
    assert delta["bandwidth"]["bsk_bytes_unfused"] == 3000
    json.dumps(delta)


# --- serve-stack integration -------------------------------------------------

def _burst(rt_cls, fault_cls, ctx, x, tel, g):
    def chaos(request, attempt):
        if request.client_id == "poison":
            raise RuntimeError("poisoned request")

    rt = rt_cls(ctx, fused=False, max_inflight=4,
                fault=fault_cls(max_retries=1), fault_hook=chaos,
                start_paused=True, telemetry=tel)
    handles = [rt.submit(g, [x], client_id=f"c{i % 4}") for i in range(12)]
    bad = [rt.submit(g, [x], client_id="poison") for _ in range(2)]
    rt.resume()
    rt.close()
    return rt, handles, bad


def test_concurrent_burst_metrics_consistent(ctx_2bit):
    """A multi-client burst with queueing and a poisoned client: spans,
    counters, histograms and the stats view agree, the trace round-trips
    valid, and the port's counters equal the reference runtime's on the
    same JAX-encrypted input."""
    x = ctx_2bit.encrypt(jax.random.key(8), np.array([1]))
    jrt, _, _ = _burst(JaxServeRuntime, JaxFaultConfig, ctx_2bit, x,
                       jobs.Telemetry(), jtrace(lambda v: v + np.array([1]), (1,)))
    tctx = port_context(ctx_2bit)
    tel = tobs.Telemetry(trace=True)
    rt, handles, bad = _burst(ServeRuntime, FaultConfig, tctx,
                              u64_to_tensor(np.asarray(x), "cpu"), tel,
                              trace(lambda v: v + np.array([1]), (1,)))
    n_total = len(handles) + len(bad)
    snap = rt.metrics()
    c = snap["counters"]
    assert c == jrt.metrics()["counters"]
    assert c["serve.admitted"] == n_total
    assert c["serve.completed"] == len(handles)
    assert c["serve.failed"] == len(bad)
    assert c["serve.retries"] == len(bad)   # max_retries=1 -> 1 re-run each
    assert snap["histograms"]["serve.request_latency_s"]["count"] == n_total
    assert snap["histograms"]["serve.queue_wait_s"]["count"] == n_total
    assert snap["histograms"]["serve.queue_depth"]["max"] >= 4
    assert rt.stats["completed"] == c["serve.completed"]
    assert rt.stats["failed"] == c["serve.failed"]
    assert len(rt.stats["admitted"]) == n_total

    events = tel.recorder.events()
    req_spans = [e for e in events if e.name == "request"]
    assert len(req_spans) == n_total
    outcomes = [e.args["outcome"] for e in req_spans]
    assert outcomes.count("completed") == c["serve.completed"]
    assert outcomes.count("failed") == c["serve.failed"]
    assert len([e for e in events if e.name == "submit"]) == n_total
    assert len([e for e in events if e.name == "queue_wait"]) == n_total
    assert len([e for e in events if e.name == "retry"]) == c["serve.retries"]
    assert jobs.validate_chrome_trace(json.dumps(tel.chrome_trace())) > 0
    for h in handles:
        assert int(tctx.decrypt(h.outputs()[0][0])) == 2


def test_output_futures_resolve_and_fail(ctx_2bit):
    tctx = port_context(ctx_2bit)
    rt = ServeRuntime(tctx, fused=False)
    g = trace(lambda v: v + np.array([1]), (1,))
    x = tctx.encrypt(torch.Generator().manual_seed(9), torch.tensor([2]))
    h = rt.submit(g, [x], client_id="A")
    (fut,) = h.output_futures
    out = fut.wait(timeout=30)              # per-output completion handle
    assert fut.done() and fut.error is None
    assert int(tctx.decrypt(out[0])) == 3
    h.wait(timeout=30)
    assert fut.completed_at <= h.completed_at
    assert h.submitted_at <= h.admitted_at <= fut.completed_at
    assert out is h.outputs()[0]

    def boom(request, attempt):
        raise RuntimeError("poisoned request")

    rt2 = ServeRuntime(tctx, fused=False, fault=FaultConfig(max_retries=1),
                       fault_hook=boom)
    h2 = rt2.submit(g, [x], client_id="B")
    (fut2,) = h2.output_futures
    with pytest.raises(RuntimeError, match="poisoned"):
        fut2.wait(timeout=30)               # unresolved futures fail
    assert fut2.done() and fut2.completed_at is None
    rt.close()
    rt2.close()


def test_fused_wave_publishes_scheduler_and_bandwidth(ctx_4bit, engine_4bit):
    """One small fused radix wave (a replayed request in it), started
    paused so every request joins the barrier before the first round:
    scheduler counters agree between the stats view and the snapshot and
    equal the reference runtime's on the same JAX-encrypted inputs,
    pbs_round spans carry fused batch ids, and the bandwidth ledger
    reconciles with the port engine's resident key operands."""
    jic = JaxIntegerContext.create(ctx_4bit, engine_4bit)
    m = jic.spec(BITS).msg_bits
    encs, wants = [], []
    for i, (a, b) in enumerate([(17, 201), (90, 90)]):
        encs.append(jax_encrypt(jic, jax.random.key(60 + i), [a, b], BITS))
        wants.append((a + b) % 256)
    encs.append(encs[0])                       # replayed ciphertexts
    wants.append(wants[0])

    def wave(rt, g, to):
        handles = [rt.submit(g, [to(e) for e in enc], client_id=f"c{i}")
                   for i, enc in enumerate(encs)]
        rt.resume()
        rt.close()
        return handles

    jrt = JaxServeRuntime(ctx_4bit, engine_4bit, max_inflight=3, start_paused=True)
    jrt.scheduler.max_wait_s = 600.0
    wave(jrt, jax_binop("radix_add", BITS, m), lambda e: e)
    tctx = port_context(ctx_4bit)
    engine = TaurusEngine.from_context(tctx, device="cpu")
    tel = tobs.Telemetry(trace=True)
    rt = ServeRuntime(tctx, engine, max_inflight=3, start_paused=True, telemetry=tel)
    for s in rt.shards:
        s.scheduler.max_wait_s = 600.0
    handles = wave(rt, radix_binop_program("radix_add", BITS, m),
                   lambda e: u64_to_tensor(np.asarray(e), "cpu"))
    ic = IntegerContext.create(tctx, engine)
    for h, want in zip(handles, wants):
        assert decrypt_radix_output(ic, h.outputs()[0], BITS)[0] == want

    snap = rt.metrics()
    c = snap["counters"]
    jc = jrt.metrics()["counters"]
    sv = rt.scheduler.stats
    for key in ("fused_rounds", "logical_luts", "dispatched_luts",
                "padded_luts", "dedup_hits", "ks_dedup_hits"):
        assert sv[key] == c[f"sched.{key}"] == jc[f"sched.{key}"], key
    assert sv["dedup_hits"] > 0             # the replay rode the original
    assert snap["histograms"]["sched.occupancy"]["count"] == c["sched.fused_rounds"]
    assert c["integer.pbs"] == c["sched.logical_luts"]

    bsk_b, ksk_b = engine.fused_pack.resident_key_bytes
    bw = snap["bandwidth"]
    assert bw["bsk_bytes_streamed"] == bw["fused_rounds"] * bsk_b
    assert bw["ksk_bytes_streamed"] == bw["fused_rounds"] * ksk_b
    assert bw["bsk_bytes_unfused"] == bw["participants"] * bsk_b
    assert bw["bsk_bytes_saved"] == bw["bsk_bytes_unfused"] - bw["bsk_bytes_streamed"] > 0
    assert bw["rows_deduped"] == c["sched.dedup_hits"]
    jbw = jrt.metrics()["bandwidth"]
    for key in ("fused_rounds", "participants", "rows_logical",
                "rows_dispatched", "rows_padded"):
        assert bw[key] == jbw[key], key

    events = tel.recorder.events()
    rounds = [e for e in events if e.name == "pbs_round"]
    assert len(rounds) == 3 * c["sched.fused_rounds"]   # one per request
    assert all(e.args.get("round") is not None for e in rounds)
    fused = [e for e in events if e.name == "fused_round"]
    assert len(fused) == c["sched.fused_rounds"]
    assert all(e.args["participants"] == len(encs) for e in fused)
    assert tobs.validate_chrome_trace(json.dumps(tel.chrome_trace())) > 0


# --- the served round's timing spans (port only) -----------------------------

# 2 message + 2 carry bits at a size the CPU runs fast; decrypts exactly
OBS_PARAMS = TFHEParams(name="test-obs-4bit", n=48, N=1024, k=1, width=4,
                        pbs_base_log=15, pbs_level=2, ks_base_log=4, ks_level=5,
                        lwe_std=2.0 ** -45, glwe_std=2.0 ** -45)
# logical PBS of one 8-bit request of 2-bit digits (perfbench/programs/)
PBS_PER_REQUEST = {"radix_add": 20, "radix_mul": 32}
ENGINE_SPANS = ("keyswitch", "lut_batch", "lut_batch_small")


def obs_wave(tel, jobs):
    """One paused-then-resumed fused wave of 8-bit `(op, a, b)` jobs on the
    OBS_PARAMS keys; returns the runtime, the jobs' handles and their
    decrypted sums / products."""
    ctx = TFHEContext.create(torch.Generator().manual_seed(21), OBS_PARAMS, device="cpu")
    ic = IntegerContext.create(ctx)
    rt = ServeRuntime(ctx, max_inflight=len(jobs), start_paused=True, telemetry=tel)
    for s in rt.shards:
        s.scheduler.max_wait_s = 600.0
    gen = torch.Generator().manual_seed(22)
    handles = [rt.submit(radix_binop_program(op, BITS, 2),
                         encrypt_request_inputs(ic, gen, [a, b], BITS, 2),
                         client_id=f"c{i}")
               for i, (op, a, b) in enumerate(jobs)]
    rt.resume()
    rt.close()
    got = [decrypt_radix_output(ic, h.outputs()[0], BITS, 2)[0] for h in handles]
    return rt, handles, got


OBS_JOBS = [("radix_add", 17, 201), ("radix_add", 90, 90), ("radix_mul", 13, 11)]


@pytest.fixture(scope="module")
def traced_wave():
    """The jobs served under a tracing telemetry, with every CUDA event the
    recorder is asked for counted (none may be, on the CPU)."""
    tel = tobs.Telemetry(trace=True)
    asked = []
    real = tobs.TraceRecorder.cuda_event
    tobs.TraceRecorder.cuda_event = lambda self, device: asked.append(device)
    try:
        rt, handles, got = obs_wave(tel, OBS_JOBS)
    finally:
        tobs.TraceRecorder.cuda_event = real
    assert got == [(a + b) % 256 if op == "radix_add" else (a * b) % 256
                   for op, a, b in OBS_JOBS]
    return tel, rt, handles, tel.recorder.spans(), asked


def inside(kid, parent, eps=1e-9) -> bool:
    return (kid.tid == parent.tid and kid.ts >= parent.ts - eps
            and kid.ts + kid.dur <= parent.ts + parent.dur + eps)


def test_request_spans_count_their_rounds_and_pbs(traced_wave):
    _, _, handles, spans, _ = traced_wave
    for h, (op, _, _) in zip(handles, OBS_JOBS):
        rid = h.request.request_id
        (req,) = [s for s in spans if s.name == "request" and s.args["request"] == rid]
        rounds = [s for s in spans if s.name == "pbs_round" and s.args["request"] == rid]
        assert req.args["outcome"] == "completed"
        assert req.args["pbs"] == PBS_PER_REQUEST[op]
        assert req.args["rounds"] == len(rounds) > 0
        assert sum(s.args["rows"] for s in rounds) == req.args["pbs"]


def test_row_keys_spans_cover_every_logical_lut(traced_wave):
    tel, _, _, spans, _ = traced_wave
    rows = sum(s.args["rows"] for s in spans if s.name == "row_keys")
    assert rows == tel.snapshot()["counters"]["sched.logical_luts"] > 0


def test_worker_spans_carry_their_requests_id(traced_wave):
    """Every d2h lies in a row_keys on its lane; every row_keys and
    pbs_round carries the id of the request span it lies in."""
    _, _, handles, spans, _ = traced_wave
    keys = [s for s in spans if s.name == "row_keys"]
    assert all(any(inside(d, k) for k in keys) for d in spans if d.name == "d2h")
    assert len([s for s in spans if s.name == "d2h"]) == len(keys)
    ids = {h.request.request_id for h in handles}
    owners = [s for s in spans if s.name in ("request", "radix_vectors")]
    for s in spans:
        if s.name in ("row_keys", "pbs_round"):
            assert s.args["request"] in ids
            assert any(inside(s, o) and o.args["request"] == s.args["request"]
                       for o in owners), s


def test_fused_rounds_enclose_the_engines_spans(traced_wave):
    """The runtime hands its telemetry to the engine: every engine span
    lies in a fused_round on the leader's lane, every round has one, and
    the KS-dedup rounds key-switch under their own span."""
    tel, _, _, spans, _ = traced_wave
    rounds = [s for s in spans if s.name == "fused_round"]
    engine = [s for s in spans if s.cat == "engine"]
    assert {s.name for s in engine} <= set(ENGINE_SPANS)
    assert "keyswitch" in {s.name for s in engine}
    assert all(any(inside(e, r) for r in rounds) for e in engine)
    assert all(any(inside(e, r) for e in engine) for r in rounds)
    c = tel.snapshot()["counters"]
    assert len(rounds) == c["sched.fused_rounds"] == c["engine.lut_batches"]
    assert c["sched.ks_dedup_hits"] > 0


def test_spans_carry_cpu_time_and_the_cpu_no_device_time(traced_wave):
    tel, _, _, spans, asked = traced_wave
    timed = [s for s in spans if s.name != "queue_wait"]
    assert timed and all(s.cpu is not None and 0 <= s.cpu <= s.dur + 1e-3 for s in timed)
    assert all(s.cpu is None for s in spans if s.name == "queue_wait")
    assert all(e.cpu is None for e in tel.recorder.events() if e.dur is None)
    assert not any("device_ms" in s.args or "device_gap_ms" in s.args for s in spans)
    assert not any(s.cat == "device" for s in spans) and asked == []


def test_traced_wave_exports_a_valid_chrome_trace(traced_wave, tmp_path):
    tel, _, _, spans, _ = traced_wave
    path = tel.write_chrome_trace(str(tmp_path / "wave.json"))
    assert tobs.validate_chrome_trace(path) > len(spans)
    with open(path) as f:
        xs = [e for e in json.load(f)["traceEvents"] if e["ph"] == "X"]
    assert all(e["args"]["cpu_us"] >= 0 for e in xs if e["name"] != "queue_wait")


def test_untraced_wave_records_nothing_and_reads_no_cpu_clock(monkeypatch):
    """Tracing off: the recorder holds nothing, no thread CPU clock is
    read, and the engine's counters still land in the runtime's
    telemetry with no hand wiring."""
    reads = []
    real = time.thread_time
    monkeypatch.setattr(time, "thread_time", lambda: reads.append(1) or real())
    tel = tobs.Telemetry()
    rt, _, got = obs_wave(tel, OBS_JOBS[:1])
    monkeypatch.undo()
    assert got == [(17 + 201) % 256] and reads == []
    assert tel.recorder.events() == [] and tel.chrome_trace()["traceEvents"] == []
    c = tel.snapshot()["counters"]
    assert c["engine.lut_batches"] == c["sched.fused_rounds"] > 0
    assert rt.engine.telemetry is tel


def test_build_shards_keeps_an_engines_own_telemetry(ctx_2bit):
    tctx = port_context(ctx_2bit)
    own = tobs.Telemetry()
    mine = TaurusEngine.from_context(tctx, device="cpu", telemetry=own)
    rt = ServeRuntime(tctx, mine, shards=2, telemetry=tobs.Telemetry())
    assert rt.shards[0].engine.telemetry is own
    assert rt.shards[1].engine.telemetry is rt.telemetry
    rt.close()


def test_to_profiler_us_puts_spans_on_the_profilers_clock(tmp_path):
    """A span around a matmul, mapped onto torch.profiler's unix-epoch
    clock, encloses the profiler's event for that matmul within 0.2 ms."""
    from torch.profiler import ProfilerActivity, profile
    rec = tobs.TraceRecorder()
    x = torch.randn(128, 128)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with rec.span("matmul", cat="test"):
            x @ x
    path = str(tmp_path / "prof.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        obj = json.load(f)
    base_us = obj.get("baseTimeNanoseconds", 0) / 1e3
    ops = [e for e in obj["traceEvents"] if e.get("name") == "aten::matmul"]
    (span,) = rec.spans()
    lo, hi = rec.to_profiler_us(span.ts), rec.to_profiler_us(span.ts + span.dur)
    assert ops
    for e in ops:
        assert lo - 200 <= e["ts"] + base_us <= e["ts"] + base_us + e["dur"] <= hi + 200
