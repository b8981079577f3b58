"""The leader's host time to enqueue a fused round's launches, in ms: the
mean, over the window's `fused_round` spans, of the wall time of the
engine's spans inside them (`keyswitch`, `lut_batch`,
`lut_batch_small`).  The rest of a round's wall is its gather, dedup and
padding."""
from perfbench.metrics import spans

ENGINE = ("keyswitch", "lut_batch", "lut_batch_small")


def read(run):
    rounds = spans.in_window(run, "fused_round")
    kids = spans.children(rounds, run.spans, ENGINE)
    walls = [sum(k.dur for k in kids[id(r)]) for r in rounds if kids[id(r)]]
    return 1e3 * sum(walls) / len(walls) if walls else None
