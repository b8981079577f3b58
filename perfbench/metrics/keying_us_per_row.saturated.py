"""The workers' CPU time to build a row's exact dedup key, in us: the CPU
time of the window's `row_keys` spans less that of their `d2h` children
(the copies to the host and their wait for the device), over their
rows."""
from perfbench.metrics import spans


def read(run):
    keys = [s for s in spans.in_window(run, "row_keys") if spans.cpu(s) is not None]
    rows = sum(s.args["rows"] for s in keys)
    if not rows:
        return None
    kids = spans.children(keys, run.spans, ("d2h",))
    busy = sum(s.cpu - sum(k.cpu for k in kids[id(s)]) for s in keys)
    return 1e6 * busy / rows
