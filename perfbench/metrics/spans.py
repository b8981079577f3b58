"""Shared by the span readers: the spans of a `--trace 1` run that end in
the untraced window (as `round_mfu.saturated` counts its rounds), and
each span's children on its thread's lane."""
import bisect
import collections


def in_window(run, name: str) -> list:
    """The spans named `name` that end in [t0, t1]."""
    return [s for s in run.spans if s.name == name and run.t0 <= s.ts + s.dur <= run.t1]


def children(parents: list, spans: list, names: tuple) -> dict:
    """{id(parent): [the spans named in `names` inside it, on its lane]}."""
    lanes = collections.defaultdict(list)
    for s in spans:
        if s.name in names:
            lanes[s.tid].append(s)
    for lane in lanes.values():
        lane.sort(key=lambda s: s.ts)
    starts = {tid: [s.ts for s in lane] for tid, lane in lanes.items()}
    out = {}
    for p in parents:
        lane, end = lanes.get(p.tid, []), p.ts + p.dur
        i = bisect.bisect_left(starts.get(p.tid, []), p.ts)
        kids = []
        while i < len(lane) and lane[i].ts <= end:
            if lane[i].ts + lane[i].dur <= end:
                kids.append(lane[i])
            i += 1
        out[id(p)] = kids
    return out


def cpu(span):
    """A span's CPU seconds, or None where the program records none."""
    return getattr(span, "cpu", None)
