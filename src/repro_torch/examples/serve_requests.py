"""Multi-tenant FHE serving through the `repro_torch.api` front door.

    python -m repro_torch.examples.serve_requests [--device cpu]

Three clients trace encrypted wide-integer programs (add / sub / relu)
with ONE `Session` and submit them to its serve backend; one client
retries a request, submitting the identical ciphertexts twice.  The
runtime executes all of them concurrently: every PBS round that is ready
across the in-flight requests fuses into ONE `TaurusEngine.lut_batch`,
and the retried request's rounds dedup against its twin.  The port of
`examples/serve_requests.py`.
"""
from __future__ import annotations

import sys

from repro_torch.api import IntSpec, Session
from repro_torch.core.engine import TaurusEngine
from repro_torch.core.params import TEST_PARAMS_4BIT
from repro_torch.core.pbs import TFHEContext
from repro_torch.device import resolve_device
from repro_torch.examples import generator, parser

BITS = 8
REQUESTS = (("alice", "add", [173, 209]), ("bob", "sub", [60, 77]), ("carol", "relu", [-5]))


def wants() -> list:
    """The demo's plaintext oracles, one per request (alice's retry last)."""
    out = [(173 + 209) % 256, (60 - 77) % 256, 0]
    return out + [out[0]]


def main(argv=None) -> int:
    args = parser(__doc__).parse_args(argv)
    device = resolve_device(args.device)
    ctx = TFHEContext.create(generator(device, 0), TEST_PARAMS_4BIT, device=device)
    engine = TaurusEngine.from_context(ctx, device=device)
    sess = Session(ctx, engine, backend="serve", max_inflight=4, start_paused=True)

    progs = {"add": sess.trace(lambda a, b: a + b, IntSpec(BITS), IntSpec(BITS)),
             "sub": sess.trace(lambda a, b: a - b, IntSpec(BITS), IntSpec(BITS)),
             "relu": sess.trace(lambda a: a.relu(), IntSpec(BITS))}
    gen = generator(device, 1)
    jobs = [(client, progs[op], sess.encrypt_inputs(gen, values, progs[op]), want)
            for (client, op, values), want in zip(REQUESTS, wants())]
    # alice's client retries her request: identical ciphertexts resubmitted
    jobs.append(("alice", jobs[0][1], jobs[0][2], wants()[3]))

    handles = [sess.submit(prog, enc, client_id=c) for c, prog, enc, _ in jobs]
    rt = sess.backend.runtime
    rt.resume()                                   # serve the whole wave
    rt.drain()

    for h, (client, prog, _, want) in zip(handles, jobs):
        got = sess.decrypt_outputs(prog, h.outputs())[0]
        ok = "ok" if got == want else "WRONG"
        print(f"  {client:6s} request {h.request.request_id}: "
              f"dec = {got:3d} (expect {want:3d}) {ok}")

    s = rt.scheduler.stats
    print(f"\n[serve] {rt.stats['completed']} requests, "
          f"{s['fused_rounds']} fused PBS rounds, "
          f"{s['logical_luts']} logical LUTs -> "
          f"{s['dispatched_luts']} dispatched "
          f"(dedup hit-rate {rt.scheduler.dedup_hit_rate:.0%}, "
          f"mean occupancy {rt.scheduler.mean_occupancy:.0%})")
    sess.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
