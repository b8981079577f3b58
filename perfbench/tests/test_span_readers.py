"""CPU tests of the span readers (`launch_ms`, `round_device_ms`,
`between_rounds`, `keying_us_per_row`, `front_door_us_per_pbs`) on
synthetic runs, on spans shaped as a program without these spans
records them, and on a stand-in PBS."""
import dataclasses

import pytest

from perfbench import harness
from perfbench.tests import standin
from repro_torch.obs import SpanEvent

NAMES = ("launch_ms", "round_device_ms", "between_rounds", "keying_us_per_row",
         "front_door_us_per_pbs")
T0, T1 = 10.0, 12.0


def read(name, spans):
    run = harness.Run(params=None, config={}, traffic={}, seconds=T1 - T0, t0=T0, t1=T1,
                      spans=sorted(spans, key=lambda s: s.ts))
    return harness.load_file("metrics", f"{name}.saturated").read(run)


def sp(name, ts, dur, tid=0, cpu=None, **args):
    return SpanEvent(name, "x", ts, dur, tid, f"t{tid}", args, cpu)


def rounds():
    """Three leader rounds: two end in the window (one on the KS-dedup
    path), one after it; an engine span on another lane overlaps."""
    return [
        sp("fused_round", 10.1, 0.2, device_ms=150.0, device_gap_ms=20.0, dispatched=8),
        sp("keyswitch", 10.15, 0.002), sp("lut_batch_small", 10.16, 0.03),
        sp("fused_round", 10.5, 0.2, device_ms=170.0, device_gap_ms=30.0, dispatched=8),
        sp("lut_batch", 10.55, 0.04),
        sp("lut_batch", 10.52, 0.5, tid=1),
        sp("fused_round", 11.9, 0.2, device_ms=900.0, device_gap_ms=900.0, dispatched=8),
        sp("lut_batch", 11.95, 0.1),
    ]


def test_launch_ms_is_the_mean_engine_wall_inside_the_windows_rounds():
    assert read("launch_ms", rounds()) == pytest.approx((32.0 + 40.0) / 2)


def test_round_device_ms_and_between_rounds_read_the_events_args():
    assert read("round_device_ms", rounds()) == pytest.approx(160.0)
    # (20 + 30) ms of gaps in a 2 s window
    assert read("between_rounds", rounds()) == pytest.approx(2.5)


def test_keying_is_row_keys_cpu_less_its_d2h_over_rows():
    spans = [sp("row_keys", 10.2, 0.01, tid=3, cpu=0.003, rows=100, request=1),
             sp("d2h", 10.201, 0.005, tid=3, cpu=0.001),
             sp("row_keys", 10.4, 0.01, tid=4, cpu=0.002, rows=50, request=2),
             sp("d2h", 10.401, 0.005, tid=4, cpu=0.0005),
             sp("row_keys", 12.5, 0.01, tid=4, cpu=0.5, rows=50, request=2)]
    assert read("keying_us_per_row", spans) == pytest.approx(1e6 * 0.0035 / 150)


def test_front_door_is_the_requests_own_cpu_on_every_lane_over_their_pbs():
    spans = [
        sp("request", 10.0, 1.0, tid=5, cpu=0.010, request=1, outcome="completed",
           pbs=20, rounds=2),
        sp("row_keys", 10.1, 0.01, tid=5, cpu=0.001, rows=4, request=1),
        sp("pbs_round", 10.2, 0.3, tid=5, cpu=0.004, rows=4, request=1),
        # a fan-out thread of request 1, with a round of its own
        sp("radix_vectors", 10.3, 0.4, tid=6, cpu=0.003, request=1, vectors=1),
        sp("pbs_round", 10.4, 0.2, tid=6, cpu=0.001, rows=4, request=1),
        # failed, and ended after the window: not counted
        sp("request", 10.0, 1.0, tid=7, cpu=0.5, request=2, outcome="failed", pbs=32),
        sp("request", 11.5, 1.0, tid=8, cpu=0.5, request=3, outcome="completed", pbs=32),
    ]
    assert read("front_door_us_per_pbs", spans) == pytest.approx(1e6 * 0.007 / 20)


@dataclasses.dataclass(frozen=True)
class OldSpan:
    """A span as a program without CPU times records it."""
    name: str
    cat: str
    ts: float
    dur: float
    tid: int
    thread: str
    args: dict


@pytest.mark.parametrize("name", NAMES)
def test_readers_return_none_without_their_spans(name):
    old = [OldSpan("fused_round", "x", 10.1, 0.2, 0, "t0", {"dispatched": 8, "rows": 8}),
           OldSpan("pbs_round", "x", 10.1, 0.2, 1, "t1", {"rows": 4, "round": 0}),
           OldSpan("request", "x", 10.0, 1.0, 1, "t1", {"request": 1, "outcome": "completed",
                                                   "retries": 0})]
    assert read(name, old) is None
    assert read(name, []) is None


def test_a_traced_standin_run_reads_the_host_span_metrics():
    """On the CPU the stand-in PBS replaces the engine's entry points and
    no CUDA event is made: the keying and front-door readers read, the
    launch and device readers find nothing."""
    res = standin.run(trace=True, spec=standin.tiny_spec(clients=12, pool_per_client=4,
                                                         lead_rounds=2))
    got = res["metrics"]
    assert res["correct"]
    assert got["keying_us_per_row.saturated"]["value"] > 0
    assert got["front_door_us_per_pbs.saturated"]["value"] > 0
    for name in ("launch_ms", "round_device_ms", "between_rounds"):
        assert f"{name}.saturated" not in got
