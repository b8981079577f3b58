"""The device's share of the window between fused rounds, in percent,
with no profiler: the window's rounds' `device_gap_ms` (the previous
round's end event to this round's start event, on one engine) over the
window's wall.  The workers' own small kernels and key copies run in
these gaps."""
from perfbench.metrics import spans


def read(run):
    gaps = [s.args["device_gap_ms"] for s in spans.in_window(run, "fused_round")
            if "device_gap_ms" in s.args]
    return 100.0 * sum(gaps) / 1e3 / (run.t1 - run.t0) if gaps else None
