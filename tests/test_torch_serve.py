"""The port's serving runtime (`repro_torch.serve`) against `repro.serve`.

The same JAX-encrypted inputs, carried across with `u64_to_tensor`, run
through the reference's runtime or interpreter and the port's, on the
`ctx_2bit` / `ctx_4bit` keys; the port's kernels run their plain versions
on the CPU.  Tolerance: exact — decrypts, round counts, LUT counts, dedup
hits and admission orders are equal.

Every test that asserts dedup hits, occupancy or round counts starts its
runtime paused, submits every request, then resumes: all requests hold a
barrier slot before the first round, so each fused round holds every
active request's round.  It also lifts the straggler timeout out of
reach (`scheduler.max_wait_s`), so no round is flushed early because a
busy machine delayed one thread; the counts cannot depend on thread
timing, alone or under `-n 6 --dist loadfile`.  The queue-level tests
run PBS-free linear programs.
"""
import dataclasses
import sys
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.compiler.ir import trace as jtrace  # noqa: E402
from repro.core.integer import IntegerContext as JaxIntegerContext  # noqa: E402
from repro import serve as jserve  # noqa: E402
from repro.runtime.fault import FaultConfig as JaxFaultConfig  # noqa: E402
from repro_torch import serve  # noqa: E402
from repro_torch.api import Session  # noqa: E402
from repro_torch.compiler.ir import trace  # noqa: E402
from repro_torch.core.engine import TaurusEngine  # noqa: E402
from repro_torch.core.integer import IntegerContext  # noqa: E402
from repro_torch.interop import u64_to_tensor  # noqa: E402
from repro_torch.runtime.fault import FaultConfig  # noqa: E402
from test_torch_api import port_context  # noqa: E402

BITS = 8
MOD = 1 << BITS


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: the suite runs several workers on shared cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tctx_2bit(ctx_2bit):
    return port_context(ctx_2bit)


@pytest.fixture(scope="module")
def tctx_4bit(ctx_4bit):
    return port_context(ctx_4bit)


@pytest.fixture(scope="module")
def engine4(tctx_4bit):
    return TaurusEngine.from_context(tctx_4bit, device="cpu")


@pytest.fixture(scope="module")
def ic4(tctx_4bit, engine4):
    return IntegerContext.create(tctx_4bit, engine4)


@pytest.fixture(scope="module")
def jic4(ctx_4bit, engine_4bit):
    return JaxIntegerContext.create(ctx_4bit, engine_4bit)


def to_port(enc) -> list:
    return [u64_to_tensor(np.asarray(e), "cpu") for e in enc]


def barrier_only(rt):
    """Dispatch only on a complete barrier, never on the straggler
    timeout (see the module docstring)."""
    for s in rt.shards:
        if s.scheduler is not None:
            s.scheduler.max_wait_s = 600.0
    return rt


def serve_wave(rt_cls, ctx, engine, jobs, **kw):
    """Start paused, submit every (client, graph, enc) job, resume, drain."""
    rt = barrier_only(rt_cls(ctx, engine, max_inflight=len(jobs),
                             start_paused=True, **kw))
    handles = [rt.submit(g, enc, client_id=c) for c, g, enc in jobs]
    rt.resume()
    rt.drain()
    return rt, [h.outputs()[0] for h in handles]


def sched_counts(rt) -> dict:
    st = rt.scheduler.stats
    out = {k: st[k] for k in ("fused_rounds", "logical_luts", "dispatched_luts",
                              "padded_luts", "dedup_hits", "ks_dedup_hits")}
    out["mean_occupancy"] = rt.scheduler.mean_occupancy
    return out


# --- the IR execution contract, rounds unpadded ------------------------------

RADIX_CASES = {
    "radix_add": (173, 209, (173 + 209) % MOD),
    "radix_sub": (60, 77, (60 - 77) % MOD),
    "radix_mul": (13, 11, 143),
    "radix_relu": (-5, None, 0),
    "radix_cmp": (9, 200, 1),                 # a < b
}


@pytest.mark.parametrize("op", RADIX_CASES)
def test_interpreter_radix_ops_unpadded_match_jax(ctx_4bit, engine_4bit, jic4,
                                                  tctx_4bit, engine4, ic4, op):
    """Each radix op through the port's interpreter with `pad_rounds`
    off: it decrypts to the oracle and to JAX's interpreter, and runs the
    reference's rounds row for row, each dispatched unpadded."""
    a, b, want = RADIX_CASES[op]
    vals = [a] if b is None else [a, b]
    m = jic4.spec(BITS).msg_bits
    if b is None:
        jg, g = jserve.radix_unop_program(op, BITS, m), serve.radix_unop_program(op, BITS, m)
    else:
        jg, g = jserve.radix_binop_program(op, BITS, m), serve.radix_binop_program(op, BITS, m)
    enc = jserve.encrypt_request_inputs(jic4, jax.random.key(a % 97), vals, BITS)
    jinterp = jserve.IrInterpreter(ctx_4bit, engine_4bit)
    jout = jinterp.run_outputs(jg, enc)[0]
    interp = serve.IrInterpreter(tctx_4bit, engine4, pad_rounds=False)
    assert not interp.int_ctx.pad_batches
    out = interp.run_outputs(g, to_port(enc))[0]
    if op == "radix_cmp":
        got, jgot = int(tctx_4bit.decrypt(out[0])), int(ctx_4bit.decrypt(jout[0]))
    else:
        got = serve.decrypt_radix_output(ic4, out, BITS)[0]
        jgot = jserve.decrypt_radix_output(jic4, jout, BITS)[0]
    assert got == jgot == want
    stats, jstats = interp.int_ctx.stats, jinterp.int_ctx.stats
    assert stats["dispatch_sizes"] == stats["batch_sizes"] == jstats["batch_sizes"]
    assert stats["pbs"] == jstats["pbs"]


def test_pad_rounds_follows_the_engine(tctx_2bit):
    """Padding is on over a bare engine and off over a fused proxy, as
    in the reference (`IrInterpreter(pad_rounds=None)`)."""
    eng = TaurusEngine.from_context(tctx_2bit, device="cpu")
    assert serve.IrInterpreter(tctx_2bit, eng).int_ctx.pad_batches
    proxy = serve.FusedLutScheduler().proxy(eng)
    assert proxy.device == eng.device and proxy.params == eng.params
    assert not serve.IrInterpreter(tctx_2bit, proxy).int_ctx.pad_batches
    assert serve.IrInterpreter(tctx_2bit, proxy, pad_rounds=True).int_ctx.pad_batches


# --- cross-request fused rounds: the radix_add_clients wave -----------------

N_CLIENTS = 8


@pytest.fixture(scope="module")
def add_jobs(jic4):
    """Eight 8-bit radix-add clients, the last a replay of the first (the
    online-dedup case), encrypted by JAX."""
    rng = np.random.default_rng(7)
    encs, wants = [], []
    for i in range(N_CLIENTS - 1):
        a, b = int(rng.integers(0, MOD)), int(rng.integers(0, MOD))
        encs.append(jserve.encrypt_request_inputs(jic4, jax.random.key(100 + i),
                                                  [a, b], BITS))
        wants.append((a + b) % MOD)
    encs.append(encs[0])
    wants.append(wants[0])
    return encs, wants


@pytest.fixture(scope="module")
def port_add_wave(tctx_4bit, engine4, jic4, add_jobs):
    g = serve.radix_binop_program("radix_add", BITS, jic4.spec(BITS).msg_bits)
    jobs = [(f"client-{i}", g, to_port(e)) for i, e in enumerate(add_jobs[0])]
    return serve_wave(serve.ServeRuntime, tctx_4bit, engine4, jobs)


def test_radix_add_clients_gate(ctx_4bit, engine_4bit, jic4, ic4, add_jobs,
                                port_add_wave):
    """The reference's `radix_add_clients` wave through its runtime and
    the port's on the same inputs: 160 logical and 140 dispatched LUTs,
    4 fused rounds, 20 dedup and 28 KS-dedup hits, every round the whole
    wave, and the same decrypts."""
    encs, wants = add_jobs
    jg = jserve.radix_binop_program("radix_add", BITS, jic4.spec(BITS).msg_bits)
    jrt, jouts = serve_wave(jserve.ServeRuntime, ctx_4bit, engine_4bit,
                            [(f"client-{i}", jg, e) for i, e in enumerate(encs)])
    rt, outs = port_add_wave
    want_counts = {"fused_rounds": 4, "logical_luts": 160, "dispatched_luts": 140,
                   "padded_luts": 160, "dedup_hits": 20, "ks_dedup_hits": 28,
                   "mean_occupancy": 1.0}
    assert sched_counts(rt) == sched_counts(jrt) == want_counts
    for out, jout, want in zip(outs, jouts, wants):
        assert (serve.decrypt_radix_output(ic4, out, BITS)[0]
                == jserve.decrypt_radix_output(jic4, jout, BITS)[0] == want)


def test_fused_dedup_on_off_decrypts_identical(tctx_4bit, engine4, ic4, add_jobs,
                                               port_add_wave):
    """Dedup on and off, and each request alone through the interpreter,
    decrypt alike: dedup removes only the replay's rows."""
    encs, wants = add_jobs
    rt_on, outs_on = port_add_wave
    g = serve.radix_binop_program("radix_add", BITS, ic4.spec(BITS).msg_bits)
    jobs = [(f"client-{i}", g, to_port(e)) for i, e in enumerate(encs)]
    rt_off, outs_off = serve_wave(serve.ServeRuntime, tctx_4bit, engine4, jobs,
                                  dedup=False)
    seq = serve.IrInterpreter(tctx_4bit, engine4)
    for (_, _, enc), o_on, o_off, want in zip(jobs[:2], outs_on, outs_off, wants):
        o_seq = seq.run_outputs(g, enc)[0]
        assert (serve.decrypt_radix_output(ic4, o_on, BITS)[0]
                == serve.decrypt_radix_output(ic4, o_off, BITS)[0]
                == serve.decrypt_radix_output(ic4, o_seq, BITS)[0] == want)
    for o_on, o_off in zip(outs_on, outs_off):
        assert (serve.decrypt_radix_output(ic4, o_on, BITS)
                == serve.decrypt_radix_output(ic4, o_off, BITS))
    on, off = sched_counts(rt_on), sched_counts(rt_off)
    assert on["dedup_hits"] == 20 and off["dedup_hits"] == 0
    assert on["mean_occupancy"] == off["mean_occupancy"] == 1.0
    assert on["fused_rounds"] == off["fused_rounds"]
    assert on["dispatched_luts"] < off["dispatched_luts"] == off["logical_luts"]


def test_wave_fuses_fully_under_thread_pressure(tctx_2bit):
    """Sixteen requests admitted in one pass, more threads than cores,
    under a 1 µs switch interval and with each admission slowed as a
    loaded host slows it: every request holds its barrier slot before any
    worker starts, so each of the program's two `lut` nodes is one fused
    round of all sixteen requests."""
    mod = tctx_2bit.params.plaintext_modulus
    table = np.array([(v + 1) % mod for v in range(mod)])
    g = trace(lambda v: (v + np.array([1])).lut(table).lut(table), (1,))
    gen = torch.Generator().manual_seed(21)
    xs = [i % (mod - 1) for i in range(16)]      # x + 1 stays inside the message space
    encs = [tctx_2bit.encrypt(gen, torch.tensor([x])) for x in xs]
    rt = barrier_only(serve.ServeRuntime(tctx_2bit, max_inflight=16,
                                         start_paused=True))
    shard, acquire = rt.shards[0], rt.shards[0].acquire

    def slow_acquire():
        time.sleep(0.02)
        acquire()

    shard.acquire = slow_acquire
    handles = [rt.submit(g, [e], client_id=f"c{i}") for i, e in enumerate(encs)]
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        rt.resume()
        outs = [h.wait(timeout=300) for h in handles]
    finally:
        sys.setswitchinterval(old)
    counts = sched_counts(rt)
    assert counts["fused_rounds"] == 2 and counts["mean_occupancy"] == 1.0
    assert counts["logical_luts"] == 32
    assert [int(tctx_2bit.decrypt(o[g.outputs[0]][0])) for o in outs] == \
        [(x + 3) % mod for x in xs]
    rt.close()


# --- intra-request fusion (tensor-level radix nodes) ------------------------

@pytest.fixture(scope="module")
def vector_add(jic4):
    m, d = jic4.spec(BITS).msg_bits, jic4.spec(BITS).n_digits
    rng = np.random.default_rng(9)
    xs = [int(v) for v in rng.integers(0, MOD, 3)]
    ys = [int(v) for v in rng.integers(0, MOD, 3)]
    enc = [jnp.concatenate(jserve.encrypt_request_inputs(
               jic4, jax.random.key(80 + j), vals, BITS))
           for j, vals in enumerate((xs, ys))]
    want = [(x + y) % MOD for x, y in zip(xs, ys)]
    return m, d, enc, want


@pytest.fixture(scope="module")
def vector_waves(ctx_4bit, engine_4bit, jic4, tctx_4bit, engine4, ic4, vector_add):
    """The (3,)-vector add as ONE request, intra_fuse on and off, through
    the reference's runtime and the port's: decrypts and counts."""
    m, d, enc, want = vector_add
    out = {}
    for name, mod, tr, ctx, eng, inputs, dec in (
            ("reference", jserve, jtrace, ctx_4bit, engine_4bit, enc,
             lambda o: jserve.decrypt_radix_output(jic4, o, BITS)),
            ("port", serve, trace, tctx_4bit, engine4, to_port(enc),
             lambda o: serve.decrypt_radix_output(ic4, o, BITS))):
        g = tr(lambda a, b: a.radix_add(b, msg_bits=m), (3, d), (3, d))
        for intra in (True, False):
            rt, (o,) = serve_wave(mod.ServeRuntime, ctx, eng, [("A", g, inputs)],
                                  intra_fuse=intra)
            out[name, intra] = (dec(o), sched_counts(rt))
    return out


@pytest.mark.parametrize("name", ["reference", "port"])
def test_intra_request_vector_fanout_fuses(vector_add, vector_waves, name):
    """ONE request adding a (3,)-tensor of radix integers: with
    intra_fuse the three vectors' carry rounds barrier into shared fused
    batches (a third of the rounds), and the port's counts are the
    reference's."""
    want = vector_add[3]
    (got_on, on), (got_off, off) = vector_waves[name, True], vector_waves[name, False]
    assert got_on == got_off == want
    assert on["logical_luts"] == off["logical_luts"]
    assert on["fused_rounds"] * 3 == off["fused_rounds"]
    assert on["mean_occupancy"] == 1.0
    assert on == vector_waves["reference", True][1]
    assert off == vector_waves["reference", False][1]


def test_fused_local_backend_fuses_vectors(tctx_4bit, engine4, vector_add, vector_waves):
    """`LocalBackend(fused=True)`: the same program through a private
    scheduler, no runtime, fuses its vectors as the served request's
    did: the same rounds, LUTs and full occupancy."""
    m, d, enc, want = vector_add
    g = trace(lambda a, b: a.radix_add(b, msg_bits=m), (3, d), (3, d))
    sess = Session(tctx_4bit, engine4, backend="local", fused=True)
    be = sess.backend
    assert isinstance(be.interp.engine, serve.FusedEngineProxy)
    out = sess.run(sess.compile(g), to_port(enc))[0]
    assert serve.decrypt_radix_output(sess.int_ctx, out, BITS) == want
    served = vector_waves["port", True][1]
    for key in ("fused_rounds", "logical_luts", "dispatched_luts"):
        assert be.scheduler.stats[key] == served[key], key
    assert be.scheduler.mean_occupancy == 1.0


# --- queue: fairness, admission, retry, validation, cancel, close -----------

@dataclasses.dataclass
class Pkg:
    """One package's runtime and its errors, plus a one-element linear
    program input (JAX-encrypted, carried across for the port)."""
    name: str
    runtime: type
    fault: type
    ctx: object
    x: object
    mod: object
    trace: object

    def graph(self, const):
        return self.trace(lambda v: v + np.array([const]), (1,))

    def value(self, handle) -> int:
        return int(self.ctx.decrypt(handle.outputs()[0][0]))


@pytest.fixture(params=["reference", "port"])
def pkg(request, ctx_2bit, tctx_2bit):
    x = ctx_2bit.encrypt(jax.random.key(4), np.array([1]))
    if request.param == "reference":
        return Pkg("reference", jserve.ServeRuntime, JaxFaultConfig, ctx_2bit, x,
                   jserve, jtrace)
    return Pkg("port", serve.ServeRuntime, FaultConfig, tctx_2bit,
               u64_to_tensor(np.asarray(x), "cpu"), serve, trace)


def _fairness_order(p: Pkg) -> list:
    rt = p.runtime(p.ctx, fused=False, max_inflight=1, start_paused=True)
    g = p.graph(1)
    handles = [rt.submit(g, [p.x], client_id="A") for _ in range(4)]
    handles += [rt.submit(g, [p.x], client_id=c) for c in "BC"]
    rt.resume()
    rt.drain()
    assert all(p.value(h) == 2 for h in handles)
    return list(rt.stats["admitted"])


def test_fairness_no_client_starves(pkg, ctx_2bit):
    """Round-robin admission: any request is admitted within
    (#clients x (its position in its own client's queue + 1))
    admissions, in the reference's order."""
    order = _fairness_order(pkg)
    assert len(order) == 6
    pos = {cid: [i for i, (c, _) in enumerate(order) if c == cid] for cid in "ABC"}
    assert pos["B"][0] < 3 and pos["C"][0] < 3
    for k, p in enumerate(pos["A"]):
        assert p < 3 * (k + 1)
    x = ctx_2bit.encrypt(jax.random.key(4), np.array([1]))
    ref = Pkg("reference", jserve.ServeRuntime, JaxFaultConfig, ctx_2bit, x,
              jserve, jtrace)
    assert order == _fairness_order(ref)


def test_admission_control_rejects_over_cap(pkg):
    rt = pkg.runtime(pkg.ctx, fused=False, max_queued_per_client=2, start_paused=True)
    g = pkg.graph(0)
    rt.submit(g, [pkg.x], client_id="A")
    rt.submit(g, [pkg.x], client_id="A")
    with pytest.raises(pkg.mod.AdmissionError):
        rt.submit(g, [pkg.x], client_id="A")
    rt.submit(g, [pkg.x], client_id="B")       # other clients unaffected
    assert rt.stats["rejected"] == 1
    rt.resume()
    rt.drain()
    assert rt.stats["completed"] == 3


def test_fault_retry_recovers(pkg):
    """A request whose execution fails (injected) retries through
    `StepRunner` and still completes."""
    boom = {"left": 2}

    def chaos(request, attempt):
        if request.client_id == "flaky" and boom["left"] > 0:
            boom["left"] -= 1
            raise RuntimeError("injected failure")

    rt = pkg.runtime(pkg.ctx, fused=False, fault=pkg.fault(max_retries=3),
                     fault_hook=chaos)
    g = pkg.graph(2)
    h_ok = rt.submit(g, [pkg.x], client_id="steady")
    h_flaky = rt.submit(g, [pkg.x], client_id="flaky")
    rt.drain()
    assert pkg.value(h_ok) == pkg.value(h_flaky) == 3
    assert h_flaky.retries == 2 and h_ok.retries == 0
    assert rt.stats["retries"] == 2 and rt.stats["failed"] == 0


def test_fault_exhausted_retries_surface(pkg):
    def always_fail(request, attempt):
        raise RuntimeError("poisoned request")

    rt = pkg.runtime(pkg.ctx, fused=False, fault=pkg.fault(max_retries=1),
                     fault_hook=always_fail)
    h = rt.submit(pkg.graph(0), [pkg.x])
    rt.drain()
    with pytest.raises(RuntimeError, match="poisoned"):
        h.wait(timeout=5)
    assert rt.stats["failed"] == 1 and h.retries == 1


def test_fused_round_failure_reaches_every_request(tctx_4bit, engine4, ic4, add_jobs):
    """An exception in a fused round reaches every request waiting on it,
    each retries through the fault layer, and the wave still decrypts."""
    encs, wants = add_jobs
    g = serve.radix_binop_program("radix_add", BITS, ic4.spec(BITS).msg_bits)
    calls = {"n": 0}
    rt = barrier_only(serve.ServeRuntime(tctx_4bit, engine4, max_inflight=2,
                                         start_paused=True,
                                         fault=FaultConfig(max_retries=1)))

    def poison(real):
        def run(cts, polys):
            calls["n"] += 1
            if calls["n"] == 2:             # the wave's second fused round
                raise RuntimeError("poisoned round")
            return real(cts, polys)
        return run

    engine4.lut_batch = poison(engine4.lut_batch)
    engine4.lut_batch_small = poison(engine4.lut_batch_small)
    try:
        handles = [rt.submit(g, to_port(e), client_id=f"c{i}")
                   for i, e in enumerate(encs[1:3])]
        rt.resume()
        rt.drain()
    finally:
        del engine4.lut_batch, engine4.lut_batch_small
    assert [h.retries for h in handles] == [1, 1]
    assert rt.stats["retries"] == 2 and rt.stats["failed"] == 0
    for h, want in zip(handles, wants[1:3]):
        assert serve.decrypt_radix_output(ic4, h.outputs()[0], BITS)[0] == want


def test_submit_validation_typed_errors(pkg):
    """Malformed requests fail AT SUBMIT with SubmitValidationError —
    not as worker-thread failures that burn fault retries."""
    rt = pkg.runtime(pkg.ctx, fused=False, start_paused=True)
    g, x = pkg.graph(1), pkg.x
    stack = np.stack if pkg.name == "reference" else torch.stack
    with pytest.raises(pkg.mod.SubmitValidationError, match="1 input nodes"):
        rt.submit(g, [], client_id="A")                 # too few inputs
    with pytest.raises(pkg.mod.SubmitValidationError, match="1 input nodes"):
        rt.submit(g, [x, x], client_id="A")             # too many
    with pytest.raises(pkg.mod.SubmitValidationError, match="expected a"):
        rt.submit(g, [x[:, :-1]], client_id="A")        # truncated ct
    with pytest.raises(pkg.mod.SubmitValidationError, match="expected a"):
        rt.submit(g, [stack([x, x])], client_id="A")    # wrong rank
    assert rt.stats["invalid"] == 4 and rt.stats["retries"] == 0
    h = rt.submit(g, [x], client_id="A")                # valid one runs
    rt.resume()
    rt.close()
    assert pkg.value(h) == 2
    with pytest.raises(pkg.mod.RuntimeClosedError):
        rt.submit(g, [x], client_id="A")


def test_cancel_queued_request_abandons(pkg):
    """`RequestHandle.abandon()` removes a still-queued request: waiters
    unblock with RequestAbandonedError, other clients are untouched."""
    rt = pkg.runtime(pkg.ctx, fused=False, start_paused=True)
    g = pkg.graph(1)
    h_a = rt.submit(g, [pkg.x], client_id="A")
    h_b = rt.submit(g, [pkg.x], client_id="B")
    assert h_a.abandon() is True
    assert h_a.abandon() is False            # already terminal
    with pytest.raises(pkg.mod.RequestAbandonedError):
        h_a.wait(timeout=1)
    with pytest.raises(pkg.mod.RequestAbandonedError):
        h_a.output_futures[0].wait(timeout=1)
    assert rt.stats["abandoned"] == 1
    rt.resume()
    rt.drain()
    assert pkg.value(h_b) == 2
    assert rt.stats["completed"] == 1
    assert h_b.abandon() is False            # a finished handle
    rt.close()


def test_close_drain_false_fails_queued_fast(pkg):
    """close(drain=False): queued requests terminate with
    RuntimeClosedError at once; no waiter hangs."""
    rt = pkg.runtime(pkg.ctx, fused=False, start_paused=True)
    g = pkg.graph(3)
    handles = [rt.submit(g, [pkg.x], client_id=f"c{i}") for i in range(3)]
    t0 = time.perf_counter()
    rt.close(drain=False)
    for h in handles:
        with pytest.raises(pkg.mod.RuntimeClosedError, match="still queued"):
            h.wait(timeout=5)
        assert h.done()
    assert time.perf_counter() - t0 < 2.0
    assert rt.stats["abandoned"] == 3 and rt.stats["completed"] == 0
    with pytest.raises(pkg.mod.RuntimeClosedError):
        rt.submit(g, [pkg.x], client_id="late")


def test_close_drain_false_lets_inflight_finish(pkg):
    """Requests already EXECUTING at close(drain=False) run to completion
    and their handles resolve normally."""
    rt = pkg.runtime(pkg.ctx, fused=False, max_inflight=1)
    h = rt.submit(pkg.graph(1), [pkg.x], client_id="A")
    h.wait(timeout=30)
    rt.close(drain=False)
    assert pkg.value(h) == 2
    assert rt.stats["completed"] == 1 and rt.stats["abandoned"] == 0


def test_close_joins_every_worker(ctx_2bit, tctx_2bit):
    """`close()` returns only once every worker thread has ended, even one
    still closing its request span after its handle resolved: a daemon
    thread left running at interpreter exit aborts the process."""
    from repro_torch.obs import Telemetry
    import threading
    workers = []

    class SlowSpanEnd(Telemetry):
        def span(self, name, cat="serve", **args):
            inner = super().span(name, cat, **args)
            if name != "request":
                return inner

            class Slow:
                def set(self, **kw):
                    inner.set(**kw)

                def __enter__(self):
                    workers.append(threading.current_thread())
                    inner.__enter__()
                    return self

                def __exit__(self, *exc):
                    time.sleep(0.3)
                    return inner.__exit__(*exc)
            return Slow()

    rt = serve.ServeRuntime(tctx_2bit, fused=False, telemetry=SlowSpanEnd())
    x = u64_to_tensor(np.asarray(ctx_2bit.encrypt(jax.random.key(4), np.array([1]))), "cpu")
    h = rt.submit(trace(lambda v: v + np.array([1]), (1,)), [x], client_id="A")
    h.wait(timeout=30)
    rt.close()
    assert len(workers) == 1 and not workers[0].is_alive()
    assert int(tctx_2bit.decrypt(h.outputs()[0][0])) == 2
