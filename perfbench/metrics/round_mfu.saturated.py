"""The whole fused round's share of the chip's peak, in percent: the
least time an H100 needs for the window's fused rounds (the algorithm's
FP64 transforms and MAC and int8 keyswitch for the rows dispatched,
after dedup and before padding, or the keys read once a round, whichever
is longer), over the window's wall.  No intermediate is counted."""
from perfbench.counts import pbs as counts


def read(run):
    if run.peaks is None:
        return None
    rounds = [s for s in run.spans
              if s.name == "fused_round" and run.t0 <= s.ts + s.dur <= run.t1]
    if not rounds:
        return None
    least = sum(counts.round_min_s(run.params, s.args["dispatched"], run.peaks) for s in rounds)
    return 100.0 * least / (run.t1 - run.t0)
