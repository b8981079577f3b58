"""The CMux step's MAC (`external_product_mac_kernel<double, J, K>`)
against its roofline: the least time of every launch in the traced
segment at the cell's (J, K) and M points, by bytes or by flops, over
its device time, in percent.  A launch's rows come from its grid, (M /
128 point tiles, rows / 2 row groups); at the decision tree's set a
step's digit planes (about 3 MB a row) stream from device memory, far
past the L2."""
import re

from perfbench.counts import pbs as counts

MAC = re.compile(r"external_product_mac_kernel<double, (\d+), (\d+)>")
THREADS, ROWS = 128, 2          # the kernel's block: a point a thread, two rows a block


def read(run):
    if run.trace is None:
        return None
    p = run.params
    K, J, M = counts.shapes(p)
    least = busy = 0.0
    for e in run.trace.events:
        m = MAC.search(e.name)
        if (m and (int(m.group(1)), int(m.group(2))) == (J, K) and len(e.grid) > 1
                and e.grid[0] * THREADS == M):
            rows = e.grid[1] * ROWS
            least += counts.launch_min_s(counts.external_product_mac(p, rows), run.peaks)
            busy += e.dur / 1e6
    return 100.0 * least / busy if busy > 0 else None
