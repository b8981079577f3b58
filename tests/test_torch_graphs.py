"""The fused pack's captured blind rotation, on the CPU.

A CUDA graph is captured and replayed only on a card
(`tests/test_torch_cuda.py` holds replays bit for bit to the eager
launches there).  Here: the cache's policy (eager, capture, replay; the
least recently used graph evicted; one capture per key under threads),
the launch counts of a capture and its replays, how the engine reads
how a rotation ran, and that CPU tensors never capture.
"""
import sys
import threading

import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import glwe  # noqa: E402
from repro_torch.core.engine import TaurusEngine  # noqa: E402
from repro_torch.core.params import TEST_PARAMS, TEST_PARAMS_K2  # noqa: E402
from repro_torch.core.pbs import TFHEContext  # noqa: E402
from repro_torch.kernels import _build, fused_pbs  # noqa: E402
from repro_torch.obs import Telemetry  # noqa: E402


@pytest.fixture
def counts():
    """Launch counts zeroed before and after the test."""
    _build.reset_launch_counts()
    yield
    _build.reset_launch_counts()


@pytest.fixture(scope="module", params=[TEST_PARAMS, TEST_PARAMS_K2], ids=lambda p: p.name)
def cpu_ctx(request):
    return TFHEContext.create(torch.Generator().manual_seed(5), request.param, device="cpu")


def inputs(ctx, B, seed):
    gen = torch.Generator().manual_seed(seed)
    mod = ctx.params.plaintext_modulus
    msgs = torch.randint(0, mod, (B,), generator=gen)
    tables = torch.randint(0, mod, (B, mod), generator=gen)
    polys = glwe.make_lut_polys_cached(tables, ctx.params, device="cpu")
    return ctx.encrypt(gen, msgs), polys, tables[torch.arange(B), msgs].tolist()


# --- the cache's policy -----------------------------------------------------------

def test_a_key_runs_eager_then_captures_then_replays():
    cache = fused_pbs.GraphCache(size=2)
    made = []
    capture = lambda: made.append(object()) or made[-1]
    assert cache.lookup("a", capture) == (None, "eager")
    graph, how = cache.lookup("a", capture)
    assert how == "capture" and graph is made[0]
    assert cache.lookup("a", capture) == (made[0], "replay")
    assert cache.lookup("a", capture) == (made[0], "replay")
    assert len(made) == 1 and list(cache.seen) == []
    assert cache.counts == {"eager": 1, "capture": 1, "replay": 2}


def test_the_least_recently_used_graph_is_evicted():
    cache = fused_pbs.GraphCache(size=2)
    for key in "abc":                       # a, b and c captured in turn
        cache.lookup(key, object)
        cache.lookup(key, object)
    assert list(cache.graphs) == ["b", "c"]
    cache.lookup("b", object)               # b used last: c goes next
    cache.lookup("d", object)
    cache.lookup("d", object)
    assert list(cache.graphs) == ["b", "d"]
    assert cache.lookup("a", object) == (None, "eager")     # evicted: seen anew


def test_keys_seen_once_evict_no_graph_and_stay_bounded():
    cache = fused_pbs.GraphCache(size=2, seen=3)
    cache.lookup("a", object)
    graph, _ = cache.lookup("a", object)
    for key in range(10):                   # one-off row counts
        assert cache.lookup(key, object) == (None, "eager")
    assert list(cache.graphs) == ["a"] and list(cache.seen) == [7, 8, 9]
    assert cache.lookup("a", object) == (graph, "replay")


def test_a_failed_capture_caches_nothing():
    cache = fused_pbs.GraphCache()
    cache.lookup("a", object)

    def fail():
        raise RuntimeError("capture failed")
    with pytest.raises(RuntimeError, match="capture failed"):
        cache.lookup("a", fail)
    assert not cache.graphs and not cache.capturing
    assert cache.counts == {"eager": 1, "capture": 0, "replay": 0}
    assert cache.lookup("a", object) == (None, "eager")


def test_threads_capture_each_key_once():
    """Eight threads look up four keys 200 times each, with a short switch
    interval: every key is captured once, and every lookup after a key's
    capture replays that graph."""
    cache = fused_pbs.GraphCache(size=4)
    made = {}
    lock = threading.Lock()
    seen = []

    def capture(key):
        with lock:
            made[key] = made.get(key, 0) + 1
        return ("graph", key)

    def work(t):
        for i in range(200):
            key = (t + i) % 4
            graph, how = cache.lookup(key, lambda: capture(key))
            assert how == "eager" or graph == ("graph", key)
            with lock:
                seen.append(how)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(t,)) for t in range(8)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(th.is_alive() for th in threads)
    assert made == {0: 1, 1: 1, 2: 1, 3: 1}
    assert len(seen) == 1600
    assert seen.count("eager") == 4 and seen.count("capture") == 4


# --- the launch counts of a capture and its replays -------------------------------

def stub_launch(monkeypatch):
    """`_build.launch` of a kernel on a stand-in launcher and stream."""
    class Stream:
        cuda_stream = 0
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: Stream())
    dev = torch.device("cuda")
    return lambda kernel: _build.launch(kernel, lambda *a: 0, device=dev)


def test_launches_in_a_capture_count_at_each_replay(monkeypatch, counts):
    """A launch inside `capturing()` goes to the graph's tally, not to the
    counts; each `replayed(tally)` adds the tally, so the counts are the
    kernels executed.  Another thread's launches meanwhile count at once."""
    launch = stub_launch(monkeypatch)
    with _build.capturing() as tally:
        for kernel in ("fft_forward", "external_product_mac", "fft_inverse") * 3:
            launch(kernel)
        other = threading.Thread(target=launch, args=("keyswitch_mac",))
        other.start()
        other.join(timeout=30)
    assert tally == {"keyswitch_mac": 0, "fft_forward": 3, "fft_inverse": 3,
                     "external_product_mac": 3}
    assert _build.launch_counts() == {"keyswitch_mac": 1, "fft_forward": 0,
                                      "fft_inverse": 0, "external_product_mac": 0}
    launch("keyswitch_mac")
    _build.replayed(tally)
    _build.replayed(tally)
    assert _build.launch_counts() == {"keyswitch_mac": 2, "fft_forward": 6,
                                      "fft_inverse": 6, "external_product_mac": 6}
    _build.reset_launch_counts()
    assert set(_build.launch_counts().values()) == {0}


def test_a_failed_capture_counts_nothing(monkeypatch, counts):
    launch = stub_launch(monkeypatch)
    with pytest.raises(RuntimeError, match="inside"):
        with _build.capturing() as tally:
            launch("fft_forward")
            raise RuntimeError("inside")
    assert tally["fft_forward"] == 1
    assert set(_build.launch_counts().values()) == {0}
    assert getattr(_build._CAPTURE, "tally", None) is None


class Sized:
    """A stand-in graph holding `bytes`."""

    def __init__(self, n):
        self.bytes = n


@pytest.mark.parametrize("size", [1, 2])
def test_a_capture_reports_its_bytes_and_an_eviction_gives_them_back(size):
    """Each capture hands this thread its graph's bytes (`local.captured`),
    and the capture that evicts the least recently used graph also that
    graph's (`local.released`); other calls report 0 for both."""
    cache = fused_pbs.GraphCache(size=size)
    seen = []
    for key, n in (("a", 100), ("b", 20), ("c", 3)):
        for how in ("eager", "capture", "replay"):
            assert cache.lookup(key, lambda: Sized(n))[1] == how
            seen.append((cache.local.captured, cache.local.released))
    evicted = [0, 0] if size == 2 else [100, 20]
    assert seen == [(0, 0), (100, 0), (0, 0),
                    (0, 0), (20, evicted[0]), (0, 0),
                    (0, 0), (3, 100 if size == 2 else evicted[1]), (0, 0)]


# --- what a graph captures, and the CPU path -------------------------------------

@pytest.mark.parametrize("entry", ["lut_batch", "lut_batch_small"])
def test_the_engine_reads_how_the_pack_ran(cpu_ctx, monkeypatch, entry):
    """The engine takes how a rotation ran from the pack
    (`last_rotation`): the round's span gets it as `graph` and its
    counter counts it; the keyswitch's span, which rotates nothing, gets
    no `graph`."""
    tel = Telemetry(trace=True)
    engine = TaurusEngine.from_context(cpu_ctx, device="cpu", telemetry=tel)
    cts, polys, want = inputs(cpu_ctx, 2, seed=7)
    hows = iter(["eager", "capture", "replay", "replay"])
    real = fused_pbs.FusedPbsPack.pbs_from_small

    def ran(pack, small, lut_polys):
        out = real(pack, small, lut_polys)
        pack._graphs.local.how = next(hows)
        return out
    monkeypatch.setattr(fused_pbs.FusedPbsPack, "pbs_from_small", ran)
    run = (engine.lut_batch if entry == "lut_batch"
           else lambda c, q: engine.lut_batch_small(engine.keyswitch(c), q))
    outs = [run(cts, polys) for _ in range(4)]
    assert all(cpu_ctx.decrypt(o).tolist() == want for o in outs)
    spans = tel.recorder.spans()
    assert [s.args.get("graph") for s in spans if s.name == entry] == [
        "eager", "capture", "replay", "replay"]
    assert not any("graph" in s.args for s in spans if s.name == "keyswitch")
    snap = tel.snapshot()["counters"]
    assert (snap["engine.graph_eager"], snap["engine.graph_captures"],
            snap["engine.graph_replays"]) == (1, 1, 2)


def test_a_cpu_engine_sets_no_residency_gauge(cpu_ctx):
    """`engine.fft_clusters_resident` reads a card's occupancy: an engine
    on the CPU builds its pack and leaves the gauge unset."""
    tel = Telemetry()
    TaurusEngine.from_context(cpu_ctx, device="cpu", telemetry=tel).fused_pack
    assert "engine.fft_clusters_resident" not in tel.snapshot()["gauges"]


def test_the_engine_counts_the_bytes_of_captures_and_evictions(cpu_ctx, monkeypatch):
    """The engine adds a capture's graph bytes to
    `engine.graph_bytes_captured` and the bytes of the graph it evicted
    to `engine.graph_bytes_released`; eager and replayed rounds add
    nothing."""
    tel = Telemetry(trace=True)
    engine = TaurusEngine.from_context(cpu_ctx, device="cpu", telemetry=tel)
    cts, polys, _ = inputs(cpu_ctx, 2, seed=3)
    runs = iter([("eager", 0, 0), ("capture", 700, 0), ("replay", 0, 0), ("capture", 50, 700)])
    real = fused_pbs.FusedPbsPack.pbs_from_small

    def ran(pack, small, lut_polys):
        out = real(pack, small, lut_polys)
        local = pack._graphs.local
        local.how, local.captured, local.released = next(runs)
        return out
    monkeypatch.setattr(fused_pbs.FusedPbsPack, "pbs_from_small", ran)
    totals = []
    for _ in range(4):
        engine.lut_batch(cts, polys)
        snap = tel.snapshot()["counters"]
        totals.append((snap.get("engine.graph_bytes_captured", 0),
                       snap.get("engine.graph_bytes_released", 0)))
    assert totals == [(0, 0), (700, 0), (700, 0), (750, 700)]


def test_a_capture_holds_up_no_other_key():
    """While one thread captures a key, a replay of another key returns
    at once and a call at the key being captured runs eagerly; the key is
    captured once."""
    cache = fused_pbs.GraphCache()
    cache.lookup("b", object)
    graph_b, _ = cache.lookup("b", object)
    cache.lookup("a", object)
    started, release = threading.Event(), threading.Event()

    def slow():
        started.set()
        assert release.wait(timeout=30)
        return "graph a"
    th = threading.Thread(target=lambda: cache.lookup("a", slow))
    th.start()
    try:
        assert started.wait(timeout=30)
        assert cache.lookup("b", object) == (graph_b, "replay")
        assert cache.lookup("a", object) == (None, "eager")
        assert "a" not in cache.seen and cache.capturing == {"a"}
    finally:
        release.set()
        th.join(timeout=30)
    assert cache.lookup("a", object) == ("graph a", "replay")
    assert cache.counts == {"eager": 3, "capture": 2, "replay": 2}


def test_cpu_tensors_never_capture(cpu_ctx, counts):
    """On CPU tensors the pack runs the plain path at every call: no graph
    is cached or counted, the engine's three graph counters stay 0 and
    its spans carry no `graph` arg."""
    tel = Telemetry(trace=True)
    engine = TaurusEngine.from_context(cpu_ctx, device="cpu", telemetry=tel)
    pack = engine.fused_pack
    cts, polys, want = inputs(cpu_ctx, 4, seed=11)
    outs = [engine.lut_batch(cts, polys) for _ in range(3)]
    outs.append(engine.lut_batch_small(engine.keyswitch(cts), polys))
    assert all(torch.equal(o, outs[0]) for o in outs)
    assert cpu_ctx.decrypt(outs[0]).tolist() == want
    pack.pbs_from_small(pack.keyswitch(cts), polys)
    assert pack.last_rotation() is None
    assert not pack._graphs.graphs and not pack._graphs.seen
    assert pack.rotations() == {"eager": 0, "capture": 0, "replay": 0}
    snap = tel.snapshot()["counters"]
    assert [snap.get(name, 0) for name in ("engine.graph_replays", "engine.graph_captures",
                                           "engine.graph_eager")] == [0, 0, 0]
    assert snap["engine.lut_batches"] == 4
    spans = [s for s in tel.recorder.spans() if s.name in ("lut_batch", "lut_batch_small")]
    assert len(spans) == 4 and not any("graph" in s.args for s in spans)
    assert set(_build.launch_counts().values()) == {0}
