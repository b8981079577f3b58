"""Bootstraps completed per second: the logical PBS of the requests that
completed in the window (each program's count, frozen in its file),
over the window's seconds.  The closed loop opens and closes its window
on answers, so it holds whole rounds but for one round's stragglers at
each end."""


def read(run):
    done = [r for r in run.requests if r.served and run.t0 < r.done <= run.t1]
    return sum(r.pbs for r in done) / (run.t1 - run.t0)
