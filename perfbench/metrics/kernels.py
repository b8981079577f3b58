"""Shared by the kernel readers: the port's FFT launches in the traced
segment, each with the ciphertext rows it ran on (from its launch grid)
and its least time by the frozen counts."""
import re

from perfbench.counts import pbs as counts

FFT = re.compile(r"fft_kernel<(\d+), ([0-3]), double2>")


def launches(run) -> list:
    """[(kind, rows, device seconds, least seconds)] for the forward-digits
    FFT ("fwd") and the inverse-torus FFT ("inv").  A forward launch's
    grid is (blocks per cluster, rows * J), an inverse one's (blocks per
    cluster, rows * K)."""
    p, peaks = run.params, run.peaks
    K, J, M = counts.shapes(p)
    out = []
    for e in run.trace.events:
        m = FFT.search(e.name)
        if m and 2 ** int(m.group(1)) == M and len(e.grid) > 1:
            if m.group(2) == "1":
                rows = e.grid[1] / J
                bf = counts.fft_forward_digits(p, rows)
                out.append(("fwd", rows, e.dur / 1e6, counts.launch_min_s(bf, peaks)))
            elif m.group(2) == "3":
                rows = e.grid[1] / K
                bf = counts.fft_inverse_torus(p, rows)
                out.append(("inv", rows, e.dur / 1e6, counts.launch_min_s(bf, peaks)))
    return out


def roofline(run, kinds: tuple):
    """Percent of the least time over the device time, over every launch
    of `kinds` in the traced segment; None without one."""
    if run.trace is None:
        return None
    sel = [x for x in launches(run) if x[0] in kinds]
    busy = sum(x[2] for x in sel)
    return 100.0 * sum(x[3] for x in sel) / busy if busy > 0 else None
