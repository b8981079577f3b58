"""The port's `Session` front door, IR and compiler against JAX's.

Tracing is numpy on both sides, so the same traced function must yield
the same `Graph` node for node: op, inputs, shape and attrs, with tables
and weights compared as arrays.  The lowering, schedule and cost model
of every Table-II workload must agree too.  Execution: the same
JAX-encrypted inputs, carried across with `u64_to_tensor`, run through
JAX's `local` backend and the port's `eager` and `local` backends (fused
kernel backend, whose kernels run their plain versions on the CPU), and
decrypt to the same values and to the plaintext oracle.

Tolerance: exact equality for graphs, plans, costs and decrypts.
"""
import dataclasses
import functools
import sys
import threading
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro import api as japi  # noqa: E402
from repro.api.backends import LocalBackend as JaxLocalBackend  # noqa: E402
from repro.compiler import cost as jcost, ir as jir, passes as jpasses  # noqa: E402
from repro.compiler import schedule as jschedule, workloads as jworkloads  # noqa: E402
from repro.core import params as jparams  # noqa: E402
from repro.fhe_ml.executor import interpret  # noqa: E402
from repro_torch import api  # noqa: E402
from repro_torch.api.backends import LocalBackend, make_backend  # noqa: E402
from repro_torch.compiler import cost, ir, passes, schedule, workloads  # noqa: E402
from repro_torch.core import params  # noqa: E402
from repro_torch.interop import context_from_numpy, u64_to_tensor  # noqa: E402
from repro_torch.serve.interpreter import IrInterpreter  # noqa: E402
from torch_stand_in import StandInEngine  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401

BITS = 8
MOD = 1 << BITS


def _mixed_fn(a, b):
    """Every traced operator family: add/sub, relu, cmp, boolean compare
    (the program of tests/test_api.py)."""
    s = a + b
    p = (a - b).relu()
    return s, p, a.cmp(b), (a < b)


def _quickstart(a, b):
    return (a * b).relu(), a < b


def _consts(x):
    return 3 * x + 200, 7 + x, x - 9


def _consts_norm(x):
    return (x * 3 + 3) * 3


W3 = np.array([[1, -2], [3, 0], [-1, 4]], np.int64)

# name -> (fn, spec factory (api module -> specs), params name)
PROGRAMS = {
    "mixed8": (_mixed_fn, lambda m: (m.IntSpec(BITS),) * 2, "TEST_PARAMS_4BIT"),
    "quickstart16": (_quickstart, lambda m: (m.IntSpec(16),) * 2, "TEST_PARAMS_4BIT"),
    "quickstart32_gpt2": (_quickstart, lambda m: (m.IntSpec(32, msg_bits=2),) * 2,
                          "gpt2"),
    "consts": (_consts, lambda m: (m.IntSpec(BITS),), "TEST_PARAMS_4BIT"),
    "consts_norm": (_consts_norm, lambda m: (m.IntSpec(BITS, 2),), None),
    "radix_linear": (lambda v: v.linear(W3).relu(),
                     lambda m: (m.IntSpec(16, shape=(3,)),), "TEST_PARAMS_4BIT"),
    "tensor": (lambda x: (x + np.array([1, 0, 1, 0])).lut(np.array([1, 0, 3, 2])),
               lambda m: (m.TensorSpec((4,)),), "TEST_PARAMS"),
    "tensor_linear": (lambda x: x.linear(W3, np.array([1, 2])).lut(np.arange(4)[::-1])
                      * 2 - np.array([1, 1]),
                      lambda m: (m.TensorSpec((3,)),), "TEST_PARAMS"),
}


def both_params(name):
    if name is None:
        return None, None
    if name in params.PAPER_PARAMS:
        return params.PAPER_PARAMS[name], jparams.PAPER_PARAMS[name]
    return getattr(params, name), getattr(jparams, name)


def assert_same_value(got, want, where):
    if isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray) and got.dtype == want.dtype, where
        assert got.shape == want.shape and np.array_equal(got, want), where
    elif isinstance(want, (tuple, list)):
        assert type(got) is type(want) and len(got) == len(want), where
        for g, w in zip(got, want):
            assert_same_value(g, w, where)
    else:
        assert type(got) is type(want) and got == want, where


def assert_same_graph(got, want):
    assert len(got.nodes) == len(want.nodes)
    assert got.outputs == want.outputs
    for g, w in zip(got.nodes, want.nodes):
        where = (w.id, w.op)
        assert (g.id, g.op, g.inputs, g.shape) == (w.id, w.op, w.inputs, w.shape), where
        assert sorted(g.attrs) == sorted(w.attrs), where
        for k in w.attrs:
            assert_same_value(g.attrs[k], w.attrs[k], (where, k))
    assert got.lut_applications() == want.lut_applications()


def assert_same_lowering(tg, jg):
    for ks in (True, False):
        for acc in (True, False):
            tops, tstats = passes.lower_to_physical(tg, ks_dedup=ks, acc_dedup=acc)
            jops, jstats = jpasses.lower_to_physical(jg, ks_dedup=ks, acc_dedup=acc)
            assert [dataclasses.astuple(o) for o in tops] == \
                [dataclasses.astuple(o) for o in jops]
            assert dataclasses.astuple(tstats) == dataclasses.astuple(jstats)
    tops, _ = passes.lower_to_physical(tg)
    jops, _ = jpasses.lower_to_physical(jg)
    for bs in (12, 48):
        ts, js = schedule.build_schedule(tops, bs), jschedule.build_schedule(jops, bs)
        assert [dataclasses.astuple(b) for b in ts.batches] == \
            [dataclasses.astuple(b) for b in js.batches]
        assert ts.total_pbs == js.total_pbs
    return ts, js


# --- graphs, node for node -------------------------------------------------------

@pytest.mark.parametrize("name", list(PROGRAMS))
def test_traced_graph_identical(name):
    fn, specs, pname = PROGRAMS[name]
    tp, jp = both_params(pname)
    tprog = api.trace_program(fn, specs(api), tp)
    jprog = japi.trace_program(fn, specs(japi), jp)
    assert_same_graph(tprog.graph, jprog.graph)
    assert [dataclasses.asdict(s) for s in tprog.in_specs] == \
        [dataclasses.asdict(s) for s in jprog.in_specs]
    assert [(type(s).__name__, dataclasses.asdict(s)) for s in tprog.out_specs] == \
        [(type(s).__name__, dataclasses.asdict(s)) for s in jprog.out_specs]
    assert_same_lowering(tprog.graph, jprog.graph)


def test_quickstart32_round_plan():
    """The card's program: 32-bit integers of 16 two-bit digits at gpt2
    are 14 PBS rounds holding 481 logical PBS."""
    tp, _ = both_params("gpt2")
    g = api.trace_program(_quickstart, (api.IntSpec(32, msg_bits=2),) * 2, tp).graph
    rounds = []
    for n in g.nodes:
        if n.op in ir.RADIX_OPS:
            rounds += [r["luts"] for r in ir.radix_round_plan(
                n.op, n.attrs["n_digits"], n.attrs["msg_bits"])]
        elif n.op == "lut":
            rounds.append(n.n_elements)
    assert rounds == [272, 32, 32, 32, 32, 32, 1, 16, 16, 8, 4, 2, 1, 1]
    assert sum(rounds) == g.lut_applications() == 481
    for op in ("radix_mul", "radix_relu", "radix_cmp", "radix_add", "radix_linear",
               "radix_norm"):
        for d in (1, 4, 8, 16, 32):
            for m in (None, 1, 2, 3):
                assert ir.radix_round_plan(op, d, m) == jir.radix_round_plan(op, d, m)


def test_quickstart32_rounds_match_jax_runtime_at_gpt2():
    """The card's program on shapes alone at gpt2, through both packages'
    local backends on a stand-in engine with zero digits (no keys): the
    same rounds row for row, 24 of them dispatching 753 rows.  The plan
    above counts 14 because `radix_round_plan` under-counts radix_mul
    (both runtimes run one round per digit); chip_smoke.py's radix phase
    holds the card's rounds to these counts."""
    tp, jp = both_params("gpt2")
    tprog = api.trace_program(_quickstart, (api.IntSpec(32, msg_bits=2),) * 2, tp)
    jprog = japi.trace_program(_quickstart, (japi.IntSpec(32, msg_bits=2),) * 2, jp)
    width = tp.big_n + 1
    teng, jeng = StandInEngine("cpu"), StandInEngine()
    tb = LocalBackend(types.SimpleNamespace(params=tp, device="cpu"), teng)
    jb = JaxLocalBackend(types.SimpleNamespace(params=jp), jeng)
    for b in (tb, jb):
        b.interp.int_ctx._polys = lambda tables: None     # shapes only: no LUT encode
    tout = tb.execute(tprog, [torch.zeros((16, width), dtype=torch.int64)] * 2)
    jout = jb.execute(jprog, [jax.numpy.zeros((16, width), jax.numpy.uint64)] * 2)
    assert [tuple(o.shape) for o in tout] == [tuple(o.shape) for o in jout]
    assert teng.rows == jeng.rows
    assert len(teng.rows) == 24 and sum(teng.rows) == 753
    tstats, jstats = tb.interp.int_ctx.stats, jb.interp.int_ctx.stats
    assert tstats["batch_sizes"] == jstats["batch_sizes"]
    assert tstats["dispatch_sizes"] == jstats["dispatch_sizes"]
    assert tstats["pbs"] == jstats["pbs"]
    assert tstats["lut_batches"] == jstats["lut_batches"] == 23   # + the cmp_lt lut node


@functools.lru_cache(maxsize=None)
def built(module):
    return {**{k: (w.graph, w.params, w) for k, w in module.build_all().items()},
            **{k: (g, p, None) for k, (g, p) in module.build_wide().items()}}


@pytest.mark.parametrize("name", ["cnn20", "cnn50", "decision_tree", "gpt2",
                                  "gpt2_12head", "knn", "xgboost", "wide_add32",
                                  "wide_mul16", "wide_affine_relu16"])
def test_workload_graphs_lowering_and_cost_identical(name):
    """Every Table-II and wide-integer workload: same graph, same lowered
    op stream and dedup stats, same schedule, same modelled runtimes."""
    tg, tp, tw = built(workloads)[name]
    jg, jp, jw = built(jworkloads)[name]
    if jw is not None:
        assert (tw.name, tw.paper_cpu_s, tw.paper_gpu_s, tw.paper_taurus_ms,
                tw.paper_xpu_ms) == (jw.name, jw.paper_cpu_s, jw.paper_gpu_s,
                                     jw.paper_taurus_ms, jw.paper_xpu_ms)
    assert dataclasses.asdict(tp) == dataclasses.asdict(jp)
    assert_same_graph(tg, jg)
    ts, js = assert_same_lowering(tg, jg)
    tm, jm = cost.TaurusModel(tp), jcost.TaurusModel(jp)
    assert tm.runtime(ts) == jm.runtime(js)
    assert tm.bandwidth_bound_runtime(ts) == jm.bandwidth_bound_runtime(js)
    assert tm.batch_bandwidth() == jm.batch_bandwidth()
    assert cost.xpu_model(tp).runtime(ts) == jcost.xpu_model(jp).runtime(js)
    assert cost.CpuModel(tp).runtime(ts) == jcost.CpuModel(jp).runtime(js)
    assert cost.GpuModel(tp).runtime(ts) == jcost.GpuModel(jp).runtime(js)


def test_tracing_errors_match():
    spec = api.IntSpec(BITS, 2)
    with pytest.raises(TypeError, match="width"):
        api.trace_program(lambda a, b: a < b, (spec,) * 2)
    with pytest.raises(TypeError, match="EncryptedInt"):
        api.trace_program(lambda a: a + 1.5, (spec,))
    with pytest.raises(TypeError, match="negative"):
        api.trace_program(lambda x: x * -2, (spec,))
    with pytest.raises(TypeError, match="overflows the digit window"):
        api.trace_program(lambda x: x * 1000, (spec,))
    prog = api.trace_program(lambda x: (x + 0) * 1, (spec,))
    assert [n.op for n in prog.graph.nodes] == ["input"]


# --- execution against JAX --------------------------------------------------------

def port_context(ctx):
    arrays = {k: np.asarray(getattr(ctx, k))
              for k in ("lwe_sk", "glwe_sk", "big_sk", "ksk", "bsk_f")}
    return context_from_numpy(dataclasses.asdict(ctx.params), arrays, "cpu")


@pytest.fixture(scope="module")
def tctx_4bit(ctx_4bit):
    return port_context(ctx_4bit)


@pytest.fixture(scope="module")
def tctx_2bit(ctx_2bit):
    return port_context(ctx_2bit)


# name -> (fn, bits, x, y, oracle).  Both programs run at 8 bits (4 digits)
# on the 4-bit keys: a 4-bit PBS round costs ~0.5-1 s of CPU here.  Their
# 16- and 32-bit graphs are held node for node above, and the 32-bit
# quickstart program runs on the card in chip_smoke.py.
RUNS = {
    "mixed": (_mixed_fn, BITS, 173, 209,
              [(173 + 209) % MOD, 0, [1], [1]]),
    # 13 * 11 = 143 lands in the negative half of 8 bits: relu clamps it
    "quickstart": (_quickstart, BITS, 13, 11, [0, [0]]),
}


@pytest.fixture(scope="module")
def jax_runs(ctx_4bit, engine_4bit):
    """Each program once on JAX's local backend: its encrypted inputs and
    decrypted outputs."""
    out = {}
    sess = japi.Session(ctx_4bit, engine_4bit, backend="local")
    for name, (fn, bits, x, y, _) in RUNS.items():
        prog = sess.trace(fn, japi.IntSpec(bits), japi.IntSpec(bits))
        enc = sess.encrypt_inputs(jax.random.key(len(name)), [x, y], prog)
        out[name] = (enc, sess.decrypt_outputs(prog, sess.run(prog, enc)))
    return out


def plain(v):
    return int(v) if np.ndim(v) == 0 else np.asarray(v).astype(np.int64).tolist()


@pytest.mark.parametrize("backend", ["eager", "local"])
@pytest.mark.parametrize("name", list(RUNS))
def test_program_decrypts_like_jax(tctx_4bit, jax_runs, name, backend):
    fn, bits, x, y, oracle = RUNS[name]
    enc, want = jax_runs[name]
    sess = api.Session(tctx_4bit, backend=backend, kernel_backend="fused")
    assert sess.engine.kernel_backend == "fused" and sess.engine.device.type == "cpu"
    prog = sess.trace(fn, api.IntSpec(bits), api.IntSpec(bits))
    outs = sess.run(prog, [u64_to_tensor(np.asarray(e), "cpu") for e in enc])
    got = sess.decrypt_outputs(prog, outs)
    assert [plain(v) for v in got] == [plain(v) for v in want] == oracle


@pytest.mark.parametrize("backend", ["eager", "local"])
def test_tensor_program_matches_oracle(tctx_2bit, ctx_2bit, backend):
    """The EncryptedTensor path (lut + plaintext add) through the port's
    own encryption, against JAX's keyless `interpret` oracle."""
    mod = tctx_2bit.params.plaintext_modulus
    table = np.array([(3 * v + 1) % mod for v in range(mod)])
    xs = np.array([0, 1, 2, 1])
    sess = api.Session(tctx_2bit, backend=backend)
    prog = sess.trace(lambda x: (x + np.array([1, 0, 1, 0])).lut(table),
                      api.TensorSpec((4,)))
    got = sess(prog, torch.Generator().manual_seed(5), xs)[0]
    ref = interpret(prog.graph, [xs], ctx_2bit.params.width)[prog.graph.outputs[0]]
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got, table[(xs + [1, 0, 1, 0]) % mod])


def test_eager_lut_dedup_stats(tctx_2bit):
    """Two LUTs on one tensor: one keyswitch per element (KS-dedup) and
    one accumulator image (ACC-dedup), as in JAX's eager backend."""
    mod = tctx_2bit.params.plaintext_modulus
    t = np.arange(mod, dtype=np.uint64)[::-1].copy()
    g = ir.trace(lambda x: (x.lut(t, name="a"), x.lut(t, name="b")), (2,))
    be = api.EagerBackend(tctx_2bit)
    sess = api.Session(tctx_2bit, backend=be)
    prog = sess.compile(g)
    got = sess(prog, torch.Generator().manual_seed(2), np.array([1, 2]))
    for out in got:
        np.testing.assert_array_equal(out, t[np.array([1, 2])])
    assert be.stats == {"pbs": 4, "keyswitch": 2, "lut_polys": 1}


def test_own_encryption_roundtrip_through_session(tctx_4bit):
    sess = api.Session(tctx_4bit, backend="eager")
    prog = sess.trace(lambda a, b: (a, b), api.IntSpec(16), api.IntSpec(16, shape=(2,)))
    enc = sess.encrypt_inputs(torch.Generator().manual_seed(0), [0xBEEF, [1, 0xFFFF]], prog)
    assert [e.shape[0] for e in enc] == [8, 16]
    got = sess.decrypt_outputs(prog, sess.run(prog, enc))
    assert got[0] == 0xBEEF and got[1].tolist() == [1, 0xFFFF]


class FakeScheduler:
    """Counts the interpreter's barrier registrations."""

    def __init__(self):
        self.lock = threading.Lock()
        self.slots = self.registered = 0

    def register(self):
        with self.lock:
            self.slots += 1
            self.registered += 1

    def unregister(self):
        with self.lock:
            self.slots -= 1


def test_interpreter_vector_fanout_under_threads(tctx_2bit):
    """A radix node over more vectors than MAX_FANOUT threads: every
    worker registers and unregisters, the context's stats lose no update
    under a short switch interval, and the outputs equal a serial run's
    bit for bit."""
    V, bits = 40, 8
    spec = api.IntSpec(bits, 1, shape=(V,))
    g = api.trace_program(lambda a, b: a + b, (spec, spec)).graph
    width = tctx_2bit.params.big_n + 1
    gen = torch.Generator().manual_seed(3)
    enc = [torch.randint(-(1 << 62), 1 << 62, (V * bits, width), generator=gen)
           for _ in range(2)]
    sched = FakeScheduler()
    fanned = IrInterpreter(tctx_2bit, StandInEngine("cpu", sched))
    serial = IrInterpreter(tctx_2bit, StandInEngine("cpu"))
    result = {}
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        worker = threading.Thread(
            target=lambda: result.update(out=fanned.run_outputs(g, enc)[0]))
        worker.start()
        worker.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not worker.is_alive() and "out" in result
    assert sched.registered == IrInterpreter.MAX_FANOUT and sched.slots == 0
    assert torch.equal(result["out"], serial.run_outputs(g, enc)[0])
    stats, ser = fanned.int_ctx.stats, serial.int_ctx.stats
    assert stats["lut_batches"] == ser["lut_batches"] == V * bits       # 8 ripple rounds
    assert stats["pbs"] == ser["pbs"] == V * bits * 2 * bits
    assert sorted(stats["batch_sizes"]) == sorted(ser["batch_sizes"])
    assert sorted(stats["dispatch_sizes"]) == sorted(ser["dispatch_sizes"])


# --- backend construction ------------------------------------------------------

def test_make_backend_names_and_errors(tctx_2bit):
    """Every named backend builds over a CPU context's keys; `serve`
    owns a runtime that `Session`'s context manager closes; an unknown
    name and a kernel_backend beside a prebuilt engine are refused."""
    from repro_torch.serve import RuntimeClosedError, ServeRuntime
    local = make_backend("local", tctx_2bit, fused=True)
    assert isinstance(local, LocalBackend) and local.scheduler is not None
    assert make_backend("local", tctx_2bit).scheduler is None
    with api.Session(tctx_2bit, backend="serve", max_inflight=2) as sess:
        be = sess.backend
        assert isinstance(be, api.ServeBackend) and isinstance(be.runtime, ServeRuntime)
        assert be.runtime.engine is sess.engine and be.runtime.max_inflight == 2
        assert sess.metrics() == be.runtime.metrics()
    with pytest.raises(RuntimeClosedError):
        be.runtime.submit(None, [])
    with pytest.raises(TypeError, match="synchronous"):
        api.Session(tctx_2bit, backend="eager").submit(None, [])
    with pytest.raises(ValueError, match="unknown backend"):
        make_backend("remote", tctx_2bit)
    with pytest.raises(TypeError, match="kernel_backend"):
        make_backend("serve", tctx_2bit, local.interp.engine._engine,
                     kernel_backend="fused")


def test_session_kernel_backend_rejects_engine_conflict(tctx_2bit):
    sess = api.Session(tctx_2bit, backend="eager", kernel_backend="reference")
    assert sess.engine.kernel_backend == "reference"
    with pytest.raises(TypeError, match="kernel_backend"):
        api.Session(tctx_2bit, sess.engine, kernel_backend="fused")
