"""The device's idle share of the untraced window, in percent.

The profiler slows the host, so no traced wall is divided by: the traced
segment gives the device's busy time per padded PBS row (its rows are
counted from the forward-FFT launches, J transforms a row and n launches
a round), and the window's padded rows times that, over the window's
wall, is its busy share."""
from perfbench.counts import pbs as counts
from perfbench.metrics.kernels import launches


def read(run):
    if run.trace is None:
        return None
    rows = sum(x[1] for x in launches(run) if x[0] == "fwd") / run.params.n
    if rows <= 0:
        return None
    busy = run.trace.busy_s / rows * run.delta("sched.padded_luts")
    return 100.0 * (1.0 - busy / (run.t1 - run.t0))
