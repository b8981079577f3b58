"""Sharded serving in the port against the reference: the router over
`EngineShard` workers, elastic admission, device assignment, KS-level
dedup and `ConfigError`.

Pure controllers and assignments run on both packages with the same
expectations.  Waves run the reference's runtime and the port's on the
same JAX-encrypted inputs (`ctx_4bit`); each starts paused with every
request submitted before `resume()` and the straggler timeout out of
reach, so its counts cannot depend on thread timing.  Tolerance: exact
(decrypts, counts, admission orders).  Queue-level tests run PBS-free
linear programs.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro import serve as jserve  # noqa: E402
from repro.compiler.ir import trace as jtrace  # noqa: E402
from repro.launch import mesh as jmesh  # noqa: E402
from repro.runtime import elastic as jelastic  # noqa: E402
from repro_torch import serve  # noqa: E402
from repro_torch.compiler.ir import trace  # noqa: E402
from repro_torch.core.engine import ConfigError, TaurusEngine  # noqa: E402
from repro_torch.launch import mesh  # noqa: E402
from repro_torch.runtime import elastic  # noqa: E402
from test_torch_serve import (BITS, engine4, ic4, jic4, sched_counts,  # noqa: E402,F401
                              serve_wave, tctx_2bit, tctx_4bit, to_port)

ELASTIC = {"reference": jelastic, "port": elastic}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: the suite runs several workers on shared cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# --- ElasticAdmission: pure controller -----------------------------------------

@pytest.mark.parametrize("pkg", ELASTIC)
def test_elastic_policy_validation(pkg):
    policy = ELASTIC[pkg].ElasticPolicy
    with pytest.raises(ValueError, match="floor"):
        policy(ceiling=2, floor=3)
    with pytest.raises(ValueError, match="floor"):
        policy(floor=0)
    with pytest.raises(ValueError, match="step"):
        policy(step_up=0)


@pytest.mark.parametrize("pkg", ELASTIC)
def test_elastic_admission_grow_shrink_unit(pkg):
    el_mod = ELASTIC[pkg]

    def new():
        return el_mod.ElasticAdmission(el_mod.ElasticPolicy(ceiling=4, floor=1))

    el = new()
    assert el.limit == 1
    for want in (2, 3, 4):                  # backlog + saturated slots: grow
        assert el.observe(queue_depth=5, inflight=el.limit) is True
        assert el.limit == want
    assert el.observe(queue_depth=5, inflight=4) is False   # at ceiling
    assert el.high_water == 4 and el.grows == 3
    assert new().observe(queue_depth=5, inflight=0) is False
    assert el.observe(queue_depth=5, inflight=4, occupancy=0.2) is False
    assert new().observe(queue_depth=1, inflight=1, occupancy=0.9) is True
    assert el.observe(queue_depth=0, inflight=2) is True
    assert el.limit == 3                     # never cuts below running work
    assert el.observe(queue_depth=0, inflight=0) is True
    assert el.observe(queue_depth=0, inflight=0) is True
    assert el.limit == 1 and el.shrinks == 3
    assert el.observe(queue_depth=0, inflight=0) is False   # at floor


# --- device -> shard assignment -----------------------------------------------

@pytest.mark.parametrize("n_devices", [1, 2, 3, 4])
def test_shard_devices_matches_reference(n_devices):
    devs = [f"dev{i}" for i in range(n_devices)]
    for n_shards in range(1, 6):
        assert mesh.shard_devices(n_shards, devs) == \
            jmesh.shard_devices(n_shards, devs)
    with pytest.raises(ValueError, match=">= 1"):
        mesh.shard_devices(0, devs)
    with pytest.raises(RuntimeError, match="no devices"):
        mesh.shard_devices(2, [])


def test_shard_devices_default_is_the_cards(monkeypatch):
    """Without a device list the shards go to the visible CUDA devices:
    none here, so the assignment raises instead of using the CPU."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError, match="no devices"):
        mesh.shard_devices(1)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert mesh.shard_devices(3) == [(torch.device("cuda", i % 2),) for i in range(3)]


# --- ConfigError and build_shards -----------------------------------------------

def test_engine_mesh_config_error(tctx_2bit):
    """The fused backend with a mesh is rejected at construction: the
    fused kernels run per device.  Typed, and a ValueError as in the
    reference."""
    with pytest.raises(ConfigError, match="per-device"):
        TaurusEngine.from_context(tctx_2bit, mesh=("cpu", "cpu"), kernel_backend="fused")
    assert issubclass(ConfigError, ValueError)
    assert serve.ConfigError is ConfigError
    assert TaurusEngine.from_context(tctx_2bit, device="cpu").mesh is None


def test_build_shards_validation(tctx_2bit):
    eng = TaurusEngine.from_context(tctx_2bit, device="cpu")
    with pytest.raises(ConfigError, match=">= 1"):
        serve.build_shards(tctx_2bit, eng, n_shards=0)
    with pytest.raises(ConfigError, match="device_sets"):
        serve.build_shards(tctx_2bit, eng, n_shards=2, device_sets=[("cpu",)])
    with pytest.raises(TypeError, match="elastic"):
        serve.build_shards(tctx_2bit, eng, n_shards=1, elastic="yes")


def test_shards_of_one_context_share_one_pack(tctx_2bit):
    """A multi-device shard gets a one-device engine on its first device;
    every shard's engine is its own object over the key's one pack."""
    eng = TaurusEngine.from_context(tctx_2bit, device="cpu")
    shards = serve.build_shards(tctx_2bit, eng, n_shards=3,
                                device_sets=[("cpu",), ("cpu", "cpu"), ("cpu",)])
    assert shards[0].engine is eng
    assert len({id(s.engine) for s in shards}) == 3
    assert all(s.engine.kernel_backend == "fused" and s.engine.mesh is None
               and s.engine.device == torch.device("cpu") for s in shards)
    assert all(s.engine.fused_pack is eng.fused_pack for s in shards)
    assert [s.devices for s in serve.build_shards(tctx_2bit, n_shards=2)] == \
        [(tctx_2bit.device,)] * 2


# --- KS-level dedup on and off ---------------------------------------------------

@pytest.fixture(scope="module")
def three_adds(jic4):
    m = jic4.spec(BITS).msg_bits
    rng = np.random.default_rng(13)
    encs, wants = [], []
    for i in range(3):
        a, b = int(rng.integers(0, 256)), int(rng.integers(0, 256))
        encs.append(jserve.encrypt_request_inputs(jic4, jax.random.key(90 + i),
                                                  [a, b], BITS))
        wants.append((a + b) % 256)
    return m, encs, wants


def reference_wave(ctx, engine, jic, jobs, wants, port_counts, **kw) -> dict:
    """The reference's counts for a wave, undisturbed: its runtime starts
    each worker as it admits it, so under load a worker can reach its
    first PBS before the next admission registers and lead a round alone,
    splitting the wave (ROADMAP queue C).  Up to three runs, each decrypting
    to `wants`; the counts of the run with the fewest fused rounds, the
    first run that equals the port's ending the search (no split wave has
    fewer rounds than an undisturbed one)."""
    best = None
    for _ in range(3):
        jrt, jouts = serve_wave(jserve.ServeRuntime, ctx, engine, jobs, **kw)
        assert [jserve.decrypt_radix_output(jic, o, BITS)[0] for o in jouts] == wants
        counts = sched_counts(jrt)
        if best is None or counts["fused_rounds"] < best["fused_rounds"]:
            best = counts
        if best == port_counts:
            break
    return best


def test_ks_dedup_on_off_decrypts_identical(ctx_4bit, engine_4bit, tctx_4bit, engine4,
                                            ic4, jic4, three_adds):
    """A radix-add wave batches [digits, digits] against [msg, carry]
    tables every ripple round, so KS-level dedup fires; off, no decrypt
    changes and the round structure stays.  The port's counts are the
    reference's undisturbed ones in both settings."""
    m, encs, wants = three_adds
    jg = jserve.radix_binop_program("radix_add", BITS, m)
    g = serve.radix_binop_program("radix_add", BITS, m)
    counts = {}
    for ks in (True, False):
        rt, outs = serve_wave(serve.ServeRuntime, tctx_4bit, engine4,
                              [(f"c{i}", g, to_port(e)) for i, e in enumerate(encs)],
                              ks_dedup=ks)
        assert [serve.decrypt_radix_output(ic4, o, BITS)[0] for o in outs] == wants
        counts[ks] = sched_counts(rt)
        assert counts[ks] == reference_wave(ctx_4bit, engine_4bit, jic4,
                                            [(f"c{i}", jg, e) for i, e in enumerate(encs)],
                                            wants, counts[ks], ks_dedup=ks)
    assert counts[True]["ks_dedup_hits"] > 0 and counts[False]["ks_dedup_hits"] == 0
    assert counts[True]["fused_rounds"] == counts[False]["fused_rounds"]
    assert counts[True]["dispatched_luts"] == counts[False]["dispatched_luts"]


# --- router: shards=1 vs 2 vs the unsharded interpreter ----------------------------

def test_sharded_decrypt_parity_and_metrics(tctx_4bit, engine4, ic4, jic4):
    """Five requests (add, mul, add, sub, relu) through shards=1 and
    shards=2 decrypt alike, to the oracle and to each request run alone
    through the unsharded interpreter; both shards do work and publish
    their namespaces, and the two shards share one pack."""
    m = jic4.spec(BITS).msg_bits
    rng = np.random.default_rng(17)
    jobs, wants = [], []
    for i, op in enumerate(("radix_add", "radix_mul", "radix_add", "radix_sub")):
        a, b = int(rng.integers(0, 256)), int(rng.integers(0, 256))
        enc = jserve.encrypt_request_inputs(jic4, jax.random.key(110 + i), [a, b], BITS)
        jobs.append((f"client-{i}", serve.radix_binop_program(op, BITS, m), to_port(enc)))
        wants.append({"radix_add": a + b, "radix_mul": a * b, "radix_sub": a - b}[op] % 256)
    enc = jserve.encrypt_request_inputs(jic4, jax.random.key(115), [-7], BITS)
    jobs.append(("client-4", serve.radix_unop_program("radix_relu", BITS, m), to_port(enc)))
    wants.append(0)

    rt1, outs1 = serve_wave(serve.ServeRuntime, tctx_4bit, engine4, jobs, shards=1)
    rt2, outs2 = serve_wave(serve.ServeRuntime, tctx_4bit, engine4, jobs, shards=2)
    alone = serve.IrInterpreter(tctx_4bit, engine4)
    for (_, g, enc), o1, o2, want in zip(jobs, outs1, outs2, wants):
        o0 = alone.run_outputs(g, enc)[0]
        assert (serve.decrypt_radix_output(ic4, o1, BITS)[0]
                == serve.decrypt_radix_output(ic4, o2, BITS)[0]
                == serve.decrypt_radix_output(ic4, o0, BITS)[0] == want)
    c2 = rt2.metrics()["counters"]
    for i in (0, 1):
        assert c2[f"serve.shard.{i}.admitted"] > 0
        assert c2[f"serve.shard.{i}.completed"] > 0
        assert c2[f"serve.shard.{i}.fused_rounds"] > 0
        assert f"serve.shard.{i}.ks_dedup_hits" in c2
        assert c2[f"serve.shard.{i}.bsk_bytes_streamed"] > 0
    assert c2["serve.shard.0.admitted"] + c2["serve.shard.1.admitted"] == len(jobs)
    assert rt2.shards[0].engine is engine4 and rt2.shards[1].engine is not engine4
    assert rt2.shards[1].engine.fused_pack is engine4.fused_pack
    c1 = rt1.metrics()["counters"]
    assert c1["serve.shard.0.admitted"] == len(jobs)
    assert "serve.shard.1.admitted" not in c1


# --- router fairness and elastic limits (linear programs) --------------------------

PKGS = {"reference": (jserve.ServeRuntime, jtrace), "port": (serve.ServeRuntime, trace)}


@pytest.fixture(params=list(PKGS))
def linear(request, ctx_2bit, tctx_2bit):
    """(runtime class, ctx, x, graph factory, decrypt) for one package."""
    runtime, tr = PKGS[request.param]
    x = ctx_2bit.encrypt(jax.random.key(120), np.array([1]))
    ctx = ctx_2bit if request.param == "reference" else tctx_2bit
    if request.param == "port":
        x = to_port([x])[0]
    return (runtime, ctx, x, lambda c: tr(lambda v: v + np.array([c]), (1,)),
            lambda h: int(ctx.decrypt(h.outputs()[0][0])))


def _flood(rt, g, x, n_a):
    handles = [rt.submit(g, [x], client_id="A") for _ in range(n_a)]
    handles += [rt.submit(g, [x], client_id=c) for c in "BC"]
    rt.resume()
    rt.drain()
    order = list(rt.stats["admitted"])
    pos = {cid: [i for i, (c, _) in enumerate(order) if c == cid] for cid in "ABC"}
    return handles, order, pos


def test_router_balances_and_no_client_starves(linear):
    """Least-loaded placement spreads the wave over both shards, and a
    flooding client cannot starve the others."""
    runtime, ctx, x, graph, value = linear
    rt = runtime(ctx, fused=False, shards=2, max_inflight=1, start_paused=True)
    handles, order, pos = _flood(rt, graph(1), x, 4)
    assert len(order) == 6
    assert pos["B"][0] < 3 and pos["C"][0] < 3
    counters = rt.metrics()["counters"]
    assert counters["serve.shard.0.admitted"] > 0
    assert counters["serve.shard.1.admitted"] > 0
    assert all(value(h) == 2 for h in handles)


def test_elastic_cross_shard_fairness(linear):
    """Two elastic shards under a burst: each runs its OWN controller,
    both bounded by the shared ceiling and back at the floor after the
    burst; both shards take work, and no client starves."""
    runtime, ctx, x, graph, value = linear
    rt = runtime(ctx, fused=False, shards=2, elastic=True, max_inflight=2,
                 start_paused=True)
    handles, order, pos = _flood(rt, graph(2), x, 6)
    controllers = [s.elastic for s in rt.shards]
    assert controllers[0] is not controllers[1]
    for el in controllers:
        assert el.high_water <= el.policy.ceiling == 2
        assert el.limit == el.policy.floor
    assert pos["B"][0] < 3 and pos["C"][0] < 3
    counters = rt.metrics()["counters"]
    assert counters["serve.shard.0.admitted"] > 0
    assert counters["serve.shard.1.admitted"] > 0
    assert all(value(h) == 3 for h in handles)


def test_elastic_burst_ramps_and_decays(linear):
    """A burst queued before `resume()` against one elastic shard: the
    limit ramps to the ceiling while the backlog lasts, never past it,
    and decays to the floor once the burst drains."""
    runtime, ctx, x, graph, value = linear
    rt = runtime(ctx, fused=False, elastic=True, max_inflight=4, start_paused=True)
    el = rt.shards[0].elastic
    assert el.limit == el.policy.floor == 1 and el.policy.ceiling == 4
    g = graph(1)
    handles = [rt.submit(g, [x], client_id=f"c{i % 3}") for i in range(12)]
    rt.resume()
    rt.drain()
    assert el.high_water == el.policy.ceiling and el.grows == 3
    assert el.shrinks >= 1 and el.limit == el.policy.floor
    assert rt.stats["completed"] == len(handles)
    assert all(value(h) == 2 for h in handles)
