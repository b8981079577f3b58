"""The front door's CPU time per logical PBS, in us: over the window's
completed `request` spans, their own CPU time (interpreting the program,
the integer layer, the linear ops) less that of their `pbs_round` and
`row_keys` spans, on every lane that carries the request's id (the
fan-out threads' `radix_vectors` spans add theirs), over the requests'
`pbs`.  A worker that leads a round spends it inside its `pbs_round`."""
from perfbench.metrics import spans

OWN = ("request", "radix_vectors")
WORK = ("pbs_round", "row_keys")


def read(run):
    reqs = [s for s in spans.in_window(run, "request")
            if s.args.get("outcome") == "completed" and "pbs" in s.args
            and spans.cpu(s) is not None]
    pbs = sum(s.args["pbs"] for s in reqs)
    if not pbs:
        return None
    ids = {s.args["request"] for s in reqs}
    busy = 0.0
    for s in run.spans:
        if s.args.get("request") in ids and spans.cpu(s) is not None:
            if s.name in OWN:
                busy += s.cpu
            elif s.name in WORK:
                busy -= s.cpu
    return 1e6 * busy / pbs
