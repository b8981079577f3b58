"""Trace a mixed serving run and write Chrome-trace JSON, on the port.

    python -m repro_torch.examples.trace_serve [--device cpu] [--out trace_serve.json]

Two radix-add clients and one encrypted-GPT-2-block client (the
quantize-to-radix lowering from `repro_torch.fhe_ml`) run concurrently
through `ServeRuntime` with a tracing `Telemetry` attached.  Every layer
records spans: per-request `submit -> queue_wait -> admit -> row_keys
-> pbs_round (fused batch id, dedup hits) -> completed`, the scheduler's
`fused_round` dispatches and the engine's `lut_batch` calls (the runtime
hands its telemetry to the engine).  The script writes the
trace, validates it (JSON shape, span nesting, per-request coverage) and
prints the metrics snapshot's headlines; open the file at
https://ui.perfetto.dev or chrome://tracing.  The port of
`examples/trace_serve.py`.
"""
from __future__ import annotations

import sys
import time

import numpy as np

from repro_torch.api import IntSpec, Session
from repro_torch.core.engine import TaurusEngine
from repro_torch.core.params import TEST_PARAMS_4BIT
from repro_torch.core.pbs import TFHEContext
from repro_torch.device import resolve_device
from repro_torch.examples import generator, parser
from repro_torch.fhe_ml import lower
from repro_torch.fhe_ml.quantize import calibrate_radix, quantize_to_radix
from repro_torch.obs import Telemetry, validate_chrome_trace

BITS = 16
MSG_BITS = 2
D_MODEL = 2


def plaintexts():
    """The two adds' operands, the block's graph, meta and quantized input,
    and every request's oracle mod 2^BITS."""
    rng = np.random.default_rng(3)
    adds = [(int(rng.integers(0, 1 << BITS)), int(rng.integers(0, 1 << BITS)))
            for _ in range(2)]
    g, meta = lower.lower_gpt2_block_radix(D_MODEL, bits=BITS, msg_bits=MSG_BITS, seed=1)
    xf = rng.uniform(-1, 1, D_MODEL)
    rq = calibrate_radix(xf, BITS, MSG_BITS, qmax=meta["input_qmax"])
    q = quantize_to_radix(xf, rq)
    wants = [(a + b) % (1 << BITS) for a, b in adds]
    wants.append(np.asarray(meta["int_fn"](q)) % (1 << BITS))
    return adds, g, meta, q, wants


def check_coverage(tel, handles) -> None:
    """Per-request coverage: a submit instant, the request span, at least
    one pbs_round span nested inside it (same worker lane) with its fused
    batch id, and a completed marker; and the engine's spans, which the
    runtime's telemetry reaches with no wiring by hand."""
    events = tel.recorder.events()
    assert any(e.cat == "engine" for e in events), "no engine spans"
    for h in handles:
        rid = h.request.request_id
        mine = [e for e in events if e.args.get("request") == rid]
        names = {e.name for e in mine}
        for needed in ("submit", "admit", "queue_wait", "request", "completed"):
            assert needed in names, f"request {rid} missing {needed!r} event"
        req_span = next(e for e in mine if e.name == "request")
        rounds = [e for e in events
                  if e.name == "pbs_round" and e.tid == req_span.tid
                  and e.ts >= req_span.ts and e.ts + e.dur <= req_span.ts + req_span.dur]
        assert rounds, f"request {rid}: no pbs_round span inside its span"
        assert all(r.args.get("round") is not None for r in rounds), (
            f"request {rid}: pbs_round missing its fused batch id")


def main(argv=None) -> int:
    ap = parser(__doc__)
    ap.add_argument("--out", default="trace_serve.json", help="Chrome-trace output path")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    params = TEST_PARAMS_4BIT
    ctx = TFHEContext.create(generator(device, 0), params, device=device)
    engine = TaurusEngine.from_context(ctx, device=device)
    tel = Telemetry(trace=True)

    adds, g, meta, q, wants = plaintexts()
    client = Session(ctx, engine, backend="local")
    add_prog = client.trace(lambda a, b: a + b, IntSpec(BITS), IntSpec(BITS))
    block_prog = client.compile(g, meta["in_specs"], meta["out_specs"])
    reqs = []                        # (client, program, enc_inputs, want)
    for i, (name, (a, b)) in enumerate(zip(("alice", "bob"), adds)):
        enc = client.encrypt_inputs(generator(device, 10 + i), [a, b], add_prog)
        reqs.append((name, add_prog, enc, wants[i]))
    enc = client.encrypt_inputs(generator(device, 99), [q], block_prog)
    reqs.append(("carol", block_prog, enc, wants[2]))

    print(f"== traced serving run: 2 radix-add + 1 GPT-2-block clients "
          f"({BITS}-bit radix, {params.name}, {device}) ==")
    sess = Session(ctx, engine, backend="serve", telemetry=tel,
                   max_inflight=len(reqs), start_paused=True)
    handles = [sess.submit(p, e, client_id=c) for c, p, e, _ in reqs]
    rt = sess.backend.runtime
    t0 = time.perf_counter()
    rt.resume()
    rt.drain()
    dt = time.perf_counter() - t0
    for h, (c, p, _, want) in zip(handles, reqs):
        got = np.asarray(sess.decrypt_outputs(p, h.outputs())[0]) % (1 << BITS)
        print(f"   {c:6s} dec = {' '.join(map(str, np.ravel(got)))}   "
              f"(expect {' '.join(map(str, np.ravel(want)))})")
        assert np.array_equal(got, want), f"{c}: FHE != oracle"
    sess.close()

    path = tel.write_chrome_trace(args.out)
    n_events = validate_chrome_trace(path)
    check_coverage(tel, handles)

    snap = rt.metrics()
    lat = snap["histograms"]["serve.request_latency_s"]
    bw = snap["bandwidth"]
    occ = snap["histograms"]["sched.occupancy"]
    print(f"   {len(reqs)} requests in {dt:5.1f}s")
    print(f"   latency p50 {lat['p50']:.2f}s p99 {lat['p99']:.2f}s; "
          f"{snap['counters']['sched.fused_rounds']} fused rounds, "
          f"mean occupancy {occ['mean']:.0%}")
    print(f"   BSK streamed {bw['bsk_bytes_streamed'] / 1e6:.1f} MB vs "
          f"{bw['bsk_bytes_unfused'] / 1e6:.1f} MB unfused "
          f"(saved {bw['bsk_bytes_saved'] / 1e6:.1f} MB)")
    print(f"[trace_serve] {n_events} events -> {path}: valid, every request covered "
          "(open in https://ui.perfetto.dev)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
