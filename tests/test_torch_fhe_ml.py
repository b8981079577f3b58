"""The port's `fhe_ml` (quantize, lower, executor) against `repro.fhe_ml`.

Quantizers, requant tables, lowered graphs and the plaintext oracle are
numpy on both sides and must agree bit for bit: every graph node for
node (op, inputs, shape, attrs, weights and tables) and every `meta`
entry.  Execution: inputs encrypted by the JAX package are carried
across with `u64_to_tensor` and run through the port's `FheExecutor`
shim or `Session` (fused kernel backend, whose kernels run their plain
versions on the CPU); every decrypt must equal JAX's and the oracle's,
and the dedup stats must equal JAX's.  At the paper's gpt2 parameters a
shapes-only dry run of the radix GPT-2 block holds both packages'
`eager` and `local` backends to the same rounds, row for row.

Tolerance: exact for quantized integers, tables, graphs, stats and
decrypts; the float outputs of the quantize-to-radix MLP are held to
`meta["tol_fn"]` as in tests/test_fhe_ml.py.  The radix GPT-2 block runs
encrypted in tests/test_torch_fhe_ml_gpt2.py.
"""
import ast
import dataclasses
import os
import subprocess
import sys
import types
import warnings
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import repro.fhe_ml as jfhe_ml  # noqa: E402
from repro import api as japi  # noqa: E402
from repro.compiler import ir as jir  # noqa: E402
from repro.core import params as jparams  # noqa: E402
from repro.fhe_ml import executor as jexecutor, lower as jlower  # noqa: E402
from repro.fhe_ml import quantize as jquantize  # noqa: E402
import repro_torch.fhe_ml as fhe_ml  # noqa: E402
from repro_torch import api  # noqa: E402
from repro_torch.compiler import ir  # noqa: E402
from repro_torch.core import params  # noqa: E402
from repro_torch.core.integer import RadixCiphertext  # noqa: E402
from repro_torch import noise_probe  # noqa: E402
from repro_torch.fhe_ml import executor, lower, quantize  # noqa: E402
from repro_torch.interop import u64_to_tensor  # noqa: E402
from test_torch_api import assert_same_graph, assert_same_value, port_context  # noqa: E402
from torch_stand_in import StandInEngine  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401

BITS = 8
MOD = 1 << BITS
SRC = str(Path(fhe_ml.__file__).resolve().parents[2])


@pytest.fixture(scope="module")
def tctx_6bit(ctx_6bit):
    return port_context(ctx_6bit)


@pytest.fixture(scope="module")
def tctx_4bit(ctx_4bit):
    return port_context(ctx_4bit)


def to_port(enc) -> list:
    return [u64_to_tensor(np.asarray(e), "cpu") for e in enc]


# --- quantizers, bit for bit ------------------------------------------------------

# the port's own submodules: the package binds each once it is imported
# (by its tests in the same process), and exports none of them
PORT_ONLY = {"trees", "tree_reference"}


def test_package_exports_match():
    """The reference's names, on a fresh import of the port's package
    and here, where other tests may have imported its own submodules."""
    def names(m):
        return {n for n in dir(m) if not n.startswith("_")}
    code = ("import repro_torch.fhe_ml as m\n"
            "print(sorted(n for n in dir(m) if not n.startswith('_')))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, env=dict(os.environ, PYTHONPATH=SRC))
    assert out.returncode == 0, out.stderr[-2000:]
    assert set(ast.literal_eval(out.stdout.strip().splitlines()[-1])) == names(jfhe_ml)
    assert names(fhe_ml) - PORT_ONLY == names(jfhe_ml)
    assert executor.EagerBackend is api.EagerBackend
    assert executor.eval_linear_ct_op is api.eval_linear_ct_op


@pytest.mark.parametrize("width", [3, 6])
def test_affine_quantizer_bit_for_bit(width):
    for x in (np.linspace(-1.5, 2.5, 64), np.random.default_rng(0).uniform(0, 1, 4)):
        spec, jspec = quantize.calibrate(x, width), jquantize.calibrate(x, width)
        assert dataclasses.asdict(spec) == dataclasses.asdict(jspec)
        assert spec.qmax == jspec.qmax
        q = quantize.quantize_affine(x, spec)
        assert_same_value(q, jquantize.quantize_affine(x, jspec), "quantize_affine")
        deq = quantize.dequantize(q, spec)
        assert_same_value(deq, jquantize.dequantize(q, jspec), "dequantize")
        assert float(np.abs(deq - x).max()) <= spec.scale * 0.51


@pytest.mark.parametrize("bits,msg_bits,qmax", [(16, 2, None), (8, 2, 20), (32, 2, 13),
                                                (16, 4, 1000)])
def test_radix_quantizer_bit_for_bit(bits, msg_bits, qmax):
    x = np.linspace(-2.0, 1.5, 33)
    rq = quantize.calibrate_radix(x, bits, msg_bits, qmax=qmax)
    jrq = jquantize.calibrate_radix(x, bits, msg_bits, qmax=qmax)
    assert dataclasses.asdict(rq) == dataclasses.asdict(jrq)
    assert (rq.n_digits, rq.modulus, rq.qmax, rq.clip_max) == \
        (jrq.n_digits, jrq.modulus, jrq.qmax, jrq.clip_max)
    # 4x past the calibration range: both saturate at the calibrated cap
    for xs in (x, 4 * x):
        q = quantize.quantize_to_radix(xs, rq)
        assert_same_value(q, jquantize.quantize_to_radix(xs, jrq), "quantize_to_radix")
        assert int(np.abs(q).max()) <= rq.clip_max
        for v in (q, q % rq.modulus):
            assert_same_value(quantize.dequantize_radix(v, rq),
                              jquantize.dequantize_radix(v, jrq), "dequantize_radix")
    np.testing.assert_array_equal(
        quantize.quantize_to_radix(np.array([4.0, -4.0]),
                                   quantize.calibrate_radix(np.array([0.5, 1.0]), 8, 2, 20)),
        [20, -20])


@pytest.mark.parametrize("fn", [None, lower._gelu])
def test_requant_table_bit_for_bit(fn):
    out = quantize.QuantSpec(6, 0.05, 17)
    jout = jquantize.QuantSpec(6, 0.05, 17)
    for in_width, scale, zero in ((6, 0.01, 32.0), (4, 0.3, 3.5)):
        assert_same_value(quantize.requant_table(scale, zero, out, in_width, fn),
                          jquantize.requant_table(scale, zero, jout, in_width, fn),
                          "requant_table")
    assert_same_value(lower._requant_lut(6, 32, 0.02, 3, 2, 0.1, fn),
                      jlower._requant_lut(6, 32, 0.02, 3, 2, 0.1, fn), "_requant_lut")


def test_radix_range_check():
    quantize.check_radix_range(8, 127.0)
    for bound in (128.0, 1e9):
        with pytest.raises(OverflowError) as err:
            quantize.check_radix_range(8, bound, "acc")
        with pytest.raises(OverflowError) as jerr:
            jquantize.check_radix_range(8, bound, "acc")
        assert str(err.value) == str(jerr.value)
    # a hopeless lowering: 64-wide dense layers cannot fit 8-bit ints
    with pytest.raises(OverflowError) as err:
        lower.lower_mlp_radix(np.ones((64, 64)), np.ones((64, 64)), bits=8, msg_bits=2)
    with pytest.raises(OverflowError) as jerr:
        jlower.lower_mlp_radix(np.ones((64, 64)), np.ones((64, 64)), bits=8, msg_bits=2)
    assert str(err.value) == str(jerr.value)


# --- lowered graphs, node for node --------------------------------------------------

def mlp_data():
    """The reference's encrypted-MLP weights and input (rng 0)."""
    rng = np.random.default_rng(0)
    w1, w2 = rng.normal(size=(4, 6)) * 0.5, rng.normal(size=(6, 4)) * 0.5
    return w1, w2, rng.uniform(0, 1, size=(4,))


def mlp_radix_data():
    """The reference's 8-bit quantize-to-radix MLP weights and input."""
    rng = np.random.default_rng(0)
    w1, w2 = rng.normal(size=(2, 3)) * 0.5, rng.normal(size=(3, 2)) * 0.5
    return w1, w2, rng.uniform(-1, 1, size=(2,))


def _mlp(m, q):
    w1, w2, xf = mlp_data()
    return m.lower_mlp(w1, w2, q.calibrate(xf, 3), 6)


def _mlp_radix(m, q):
    w1, w2, _ = mlp_radix_data()
    return m.lower_mlp_radix(w1, w2, bits=BITS, msg_bits=2)


# name -> (lowering (lower module, quantize module) -> (graph, meta),
# oracle width, bound of the oracle's random inputs: radix digits below
# 4, affine inputs within the input spec's qmax)
LOWERINGS = {
    "mlp": (_mlp, 6, 8),
    "mlp_relu": (lambda m, q: m.lower_mlp(np.random.default_rng(4).normal(size=(3, 5)),
                                          np.random.default_rng(5).normal(size=(5, 2)),
                                          q.QuantSpec(2, 0.5, 1), 6, act="relu"), 6, 4),
    "mlp_radix8": (_mlp_radix, 4, 4),
    "mlp_radix16": (lambda m, q: m.lower_mlp_radix(
        np.random.default_rng(1).normal(size=(4, 3)),
        np.random.default_rng(2).normal(size=(3, 4)), bits=16, msg_bits=2), 4, 4),
    "gpt2_block": (lambda m, q: m.lower_gpt2_block(4, q.QuantSpec(3, 0.25, 4), 6, seed=1),
                   6, 8),
    "gpt2_block_d2": (lambda m, q: m.lower_gpt2_block(2, q.QuantSpec(2, 0.5, 1), 5), 5, 4),
    "gpt2_block_radix": (lambda m, q: m.lower_gpt2_block_radix(2, bits=16, msg_bits=2,
                                                               seed=1), 4, 4),
    "gpt2_block_radix32": (lambda m, q: m.lower_gpt2_block_radix(4, bits=32, msg_bits=2),
                           4, 4),
}


def both_lowered(name):
    fn = LOWERINGS[name][0]
    return fn(lower, quantize), fn(jlower, jquantize)


def assert_same_meta(meta, jmeta, rng):
    assert sorted(meta) == sorted(jmeta)
    for k, want in jmeta.items():
        got = meta[k]
        if k in ("in_specs", "out_specs"):
            assert [dataclasses.asdict(s) for s in got] == \
                [dataclasses.asdict(s) for s in want], k
        elif dataclasses.is_dataclass(want):
            assert dataclasses.asdict(got) == dataclasses.asdict(want), k
        elif not callable(want):
            assert_same_value(got, want, k)
    n_in = jmeta["in_specs"][0].shape[0] if "in_specs" in jmeta else None
    if "int_fn" in jmeta:
        q = rng.integers(-jmeta["input_qmax"], jmeta["input_qmax"] + 1, n_in)
        assert_same_value(meta["int_fn"](q), jmeta["int_fn"](q), "int_fn")
        xf = rng.uniform(-1, 1, n_in)
        assert_same_value(meta["float_fn"](xf), jmeta["float_fn"](xf), "float_fn")
    if "tol_fn" in jmeta:
        bits = jmeta["in_specs"][0].bits
        rq = quantize.calibrate_radix(xf, bits, 2, qmax=meta["input_qmax"])
        jrq = jquantize.calibrate_radix(xf, bits, 2, qmax=jmeta["input_qmax"])
        assert_same_value(meta["tol_fn"](rq), jmeta["tol_fn"](jrq), "tol_fn")


@pytest.mark.parametrize("name", list(LOWERINGS))
def test_lowered_graph_identical(name):
    (g, meta), (jg, jmeta) = both_lowered(name)
    assert_same_graph(g, jg)
    assert_same_meta(meta, jmeta, np.random.default_rng(len(name)))


def test_gpt2_block_sizes():
    """The blocks the card runs: the radix block admits |q| <= 13 at 16
    bits and its graph counts 1,316 PBS; the narrow block has 34 nodes,
    11 of them `lut`, holding 48 PBS."""
    g, meta = lower.lower_gpt2_block_radix(2, bits=16, msg_bits=2, seed=1)
    assert meta["input_qmax"] == 13 and g.lut_applications() == 1316
    g, _ = lower.lower_gpt2_block(4, quantize.QuantSpec(3, 0.25, 4), 6, seed=1)
    assert len(g.nodes) == 34 and sum(n.op == "lut" for n in g.nodes) == 11
    assert g.lut_applications() == 48


# --- the plaintext oracle, bit for bit ------------------------------------------------

@pytest.mark.parametrize("name", list(LOWERINGS))
def test_interpret_bit_for_bit(name):
    (g, _), (jg, _) = both_lowered(name)
    _, width, high = LOWERINGS[name]
    rng = np.random.default_rng(11)
    for _ in range(3):
        ins = [rng.integers(0, high, int(np.prod(n.shape))) for n in g.nodes
               if n.op == "input"]
        got, want = executor.interpret(g, ins, width), jexecutor.interpret(jg, ins, width)
        assert sorted(got) == sorted(want)
        for k in want:
            assert_same_value(got[k], want[k], (name, k))


def _radix_ops(a, b):
    return a + b, a - b, (a * b).relu(), a.cmp(b), 3 * a + 200, (a * 3 + 3) * 3


def test_interpret_radix_ops_bit_for_bit():
    """Every radix op of the oracle, on 32-bit operands whose products
    overflow int64 (the oracle keeps Python integers)."""
    specs = (api.IntSpec(32, 2),) * 2
    g = api.trace_program(_radix_ops, specs).graph
    jg = japi.trace_program(_radix_ops, (japi.IntSpec(32, 2),) * 2).graph
    assert_same_graph(g, jg)
    rng = np.random.default_rng(2)
    for _ in range(4):
        ins = [rng.integers(0, 4, 16) for _ in range(2)]
        got, want = executor.interpret(g, ins, 4), jexecutor.interpret(jg, ins, 4)
        for k in want:
            assert_same_value(got[k], want[k], k)


def test_radix_linear_oracle_matches_numpy():
    rng = np.random.default_rng(5)
    W = rng.integers(-2, 3, (3, 4))
    g = ir.trace(lambda x: x.radix_linear(W, 2), (3, 4))
    xs = np.array([17, -30, 5])
    inp = np.concatenate([[(int(v) % MOD) >> (2 * i) & 3 for i in range(4)] for v in xs])
    out = executor.interpret(g, [inp], 4)[g.outputs[0]].reshape(-1, 4)
    got = [sum(int(d) << (2 * i) for i, d in enumerate(vec)) for vec in out]
    np.testing.assert_array_equal(got, (xs @ W) % MOD)


def test_interpret_range_check_raises_the_same():
    t = np.arange(16)
    g = ir.trace(lambda x: (x + 10).lut(t), (2,))
    jg = jir.trace(lambda x: (x + 10).lut(t), (2,))
    with pytest.raises(OverflowError) as err:
        executor.interpret(g, [np.array([1, 9])], 4)
    with pytest.raises(OverflowError) as jerr:
        jexecutor.interpret(jg, [np.array([1, 9])], 4)
    assert str(err.value) == str(jerr.value)
    got = executor.interpret(g, [np.array([1, 9])], 4, check_range=False)
    want = jexecutor.interpret(jg, [np.array([1, 9])], 4, check_range=False)
    for k in want:
        assert_same_value(got[k], want[k], k)


# --- encrypted, against JAX on JAX-encrypted inputs -------------------------------------

def run_both(ctx, tctx, g, jg, inputs, **kw):
    """`jg` through JAX's FheExecutor and `g` through the port's on the
    same JAX ciphertexts.  Returns the oracle and each side's decrypted
    outputs and stats."""
    ref = jexecutor.interpret(jg, inputs, ctx.params.width)
    jex, ex = jexecutor.FheExecutor(ctx, **kw), executor.FheExecutor(tctx, **kw)
    enc = jex.encrypt_inputs(jax.random.PRNGKey(7), inputs)
    with pytest.warns(DeprecationWarning):
        jout = jex.run(jg, enc)
    with pytest.warns(DeprecationWarning, match="repro_torch.api.Session"):
        out = ex.run(g, to_port(enc))
    got = {o: ex.decrypt(out[o]) for o in g.outputs}
    want = {o: jex.decrypt(jout[o]).astype(np.int64) for o in jg.outputs}
    for o in jg.outputs:
        np.testing.assert_array_equal(got[o], want[o])
        np.testing.assert_array_equal(got[o], ref[o])
    assert ex.stats == jex.stats
    return ex.stats


def _fanout(t1, t2):
    return lambda x: (x.lut(t1, name="a"), x.lut(t2, name="b"))


def test_fanout_ks_dedup(ctx_6bit, tctx_6bit):
    """Two LUTs on one tensor: 5 key-switches for 10 blind rotations (10
    without KS dedup), decrypting as JAX's and the oracle."""
    w = ctx_6bit.params.width
    t1 = np.arange(1 << w, dtype=np.uint64)[::-1].copy()
    t2 = (np.arange(1 << w, dtype=np.uint64) * 3) % (1 << w)
    g, jg = ir.trace(_fanout(t1, t2), (5,)), jir.trace(_fanout(t1, t2), (5,))
    inputs = [np.array([1, 9, 22, 40, 63])]
    stats = run_both(ctx_6bit, tctx_6bit, g, jg, inputs)
    assert (stats["pbs"], stats["keyswitch"]) == (10, 5)
    stats = run_both(ctx_6bit, tctx_6bit, g, jg, inputs, ks_dedup=False)
    assert (stats["pbs"], stats["keyswitch"]) == (10, 10)


def test_acc_dedup_shares_lut_polys(ctx_6bit, tctx_6bit):
    w = ctx_6bit.params.width
    t = (np.arange(1 << w, dtype=np.uint64) + 5) % (1 << w)

    def f(x, y):
        return x.lut(t), y.lut(t)
    g, jg = ir.trace(f, (3,), (3,)), jir.trace(f, (3,), (3,))
    stats = run_both(ctx_6bit, tctx_6bit, g, jg, [np.array([0, 1, 2]), np.array([3, 4, 5])])
    assert stats["lut_polys"] == 1


def test_encrypted_mlp_matches_jax(ctx_6bit, tctx_6bit):
    (g, _), (jg, _) = both_lowered("mlp")
    xf = mlp_data()[2]
    q = quantize.quantize_affine(xf, quantize.calibrate(xf, 3))
    stats = run_both(ctx_6bit, tctx_6bit, g, jg, [q])
    assert stats["pbs"] == 6 + 4


def test_encrypted_gpt2_block_matches_jax(ctx_6bit, tctx_6bit):
    """The narrow-LUT GPT-2 block (ct*ct attention by square LUTs, GELU
    MLP) at 6-bit messages: 48 PBS in 11 lut nodes, none of them sharing
    a key-switch."""
    (g, _), (jg, _) = both_lowered("gpt2_block")
    q = np.random.default_rng(3).integers(0, 8, (4,))
    stats = run_both(ctx_6bit, tctx_6bit, g, jg, [q])
    assert stats == {"pbs": 48, "keyswitch": 48, "lut_polys": 3}


def test_executor_own_encryption(tctx_6bit):
    """The shim's client side on the port's own randomness: a torch
    Generator, drawn from in input order."""
    ex = executor.FheExecutor(tctx_6bit)
    enc = ex.encrypt_inputs(torch.Generator().manual_seed(3),
                            [np.array([[1, 2], [3, 4]]), [63]])
    assert [tuple(e.shape) for e in enc] == [(4, tctx_6bit.params.big_n + 1),
                                             (1, tctx_6bit.params.big_n + 1)]
    assert [ex.decrypt(e).tolist() for e in enc] == [[1, 2, 3, 4], [63]]


def test_radix_linear_heavy_weights_encrypted(ctx_4bit, engine_4bit, tctx_4bit):
    """Weights of magnitude >= 4 under the 4-bit window force solo
    extractions in the carry-save compression: both port backends
    decrypt as JAX's eager backend and as numpy mod 2^bits."""
    W = np.array([[4, -4], [3, 5], [-2, 1]])
    xs = np.array([17, -30, 5])
    specs = ([japi.IntSpec(BITS, 2, (3,))], [japi.IntSpec(BITS, 2, (2,))])
    with japi.Session(ctx_4bit, engine_4bit, backend="eager") as jsess:
        jprog = jsess.compile(jir.trace(lambda x: x.radix_linear(W, 2), (3, 4)), *specs)
        enc = jsess.encrypt_inputs(jax.random.key(7), [xs], jprog)
        want = np.asarray(jsess.decrypt_outputs(jprog, jsess.run(jprog, enc))[0])
    np.testing.assert_array_equal(want % MOD, (xs @ W) % MOD)
    g = ir.trace(lambda x: x.radix_linear(W, 2), (3, 4))
    for backend in ("eager", "local"):
        sess = api.Session(tctx_4bit, backend=backend, kernel_backend="fused")
        prog = sess.compile(g, [api.IntSpec(BITS, 2, (3,))], [api.IntSpec(BITS, 2, (2,))])
        got = sess.decrypt_outputs(prog, sess.run(prog, to_port(enc)))[0]
        assert_same_value(got, want, backend)


@pytest.fixture(scope="module")
def jax_mlp_radix(ctx_4bit, engine_4bit):
    """The 8-bit quantize-to-radix MLP once through JAX's eager backend:
    its input, encrypted input and decrypted output."""
    jg, jmeta = _mlp_radix(jlower, jquantize)
    xf = mlp_radix_data()[2]
    rq = jquantize.calibrate_radix(xf, BITS, 2, qmax=jmeta["input_qmax"])
    q = jquantize.quantize_to_radix(xf, rq)
    with japi.Session(ctx_4bit, engine_4bit, backend="eager") as jsess:
        jprog = jsess.compile(jg, jmeta["in_specs"], jmeta["out_specs"])
        enc = jsess.encrypt_inputs(jax.random.key(7), [q], jprog)
        want = np.asarray(jsess.decrypt_outputs(jprog, jsess.run(jprog, enc))[0])
    return xf, q, enc, want


@pytest.mark.parametrize("backend", ["eager", "local", "serve"])
def test_quantize_to_radix_mlp_roundtrip(tctx_4bit, jax_mlp_radix, backend):
    """quantize -> encrypt -> radix linear/relu -> decrypt -> dequantize:
    decrypts equal JAX's, every output digit's noise is inside the budget
    1/2^(width+2), and the floats are within `tol_fn` of the float model.
    `serve` submits through the multi-tenant `ServeRuntime`."""
    xf, q, enc, want = jax_mlp_radix
    g, meta = _mlp_radix(lower, quantize)
    rq = quantize.calibrate_radix(xf, BITS, 2, qmax=meta["input_qmax"])
    assert_same_value(quantize.quantize_to_radix(xf, rq), q, "q")
    want_ints = meta["int_fn"](q) % MOD
    sess = api.Session(tctx_4bit, backend=backend, kernel_backend="fused")
    prog = sess.compile(g, meta["in_specs"], meta["out_specs"])
    out_cts = sess.run(prog, to_port(enc))
    got = sess.decrypt_outputs(prog, out_cts)[0]
    assert_same_value(got, want, backend)
    np.testing.assert_array_equal(got % MOD, want_ints)
    spec = sess.int_ctx.spec(BITS, 2)
    vecs = out_cts[0].reshape(-1, spec.n_digits, out_cts[0].shape[-1])
    budget = 1.0 / 2 ** (tctx_4bit.params.width + 2)
    for vec, w in zip(vecs, want_ints):
        noise = sess.int_ctx.digit_noise(RadixCiphertext(spec, vec), int(w))
        assert float(np.max(np.abs(noise))) < budget
    out_rq = quantize.RadixQuantSpec(BITS, 2, rq.scale * meta["out_scale_mul"])
    yhat = quantize.dequantize_radix(got, out_rq)
    assert np.all(np.abs(yhat - meta["float_fn"](xf)) <= meta["tol_fn"](rq))


# --- the card's plan at gpt2, shapes only ---------------------------------------------

def test_probe_run_measures_every_pbs_input(tctx_4bit):
    """The noise probe's shadow run gives every PBS input row its exact
    plaintext: at the test keys' noise every row sits far inside half a
    slot, and the measured run decrypts to the sum."""
    sess = api.Session(tctx_4bit, backend="eager", kernel_backend="fused")
    prog = sess.trace(lambda a, b: a + b, api.IntSpec(BITS, 2), api.IntSpec(BITS, 2))
    enc = sess.encrypt_inputs(torch.Generator().manual_seed(4), [200, 99], prog)
    run = noise_probe.probe_run(sess, prog, enc)
    assert sess.decrypt_outputs(prog, run["outs"]) == [(200 + 99) % MOD]
    ic = sess.backend.int_ctx
    assert len(run["past_half"]) == ic.stats["lut_batches"] and set(run["past_half"]) == {0}
    assert run["errors"].size == sum(ic.stats["batch_sizes"])
    assert float(run["errors"].max()) < 1e-3


def test_gpt2_radix_block_plan_matches_jax_at_gpt2():
    """The radix GPT-2 block at the paper's gpt2 parameters on a stand-in
    engine (no keys, no bootstrap) through both packages' eager and local
    backends: 104 rounds dispatching 2,080 rows (at most 96 in a round)
    and 1,268 logical PBS, row for row alike.  The graph's own count is
    1,316: chip_smoke.py plans by such a dry run, not from the graph."""
    tp, jp = params.PAPER_PARAMS["gpt2"], jparams.PAPER_PARAMS["gpt2"]
    g, meta = lower.lower_gpt2_block_radix(2, bits=16, msg_bits=2, seed=1)
    jg, jmeta = jlower.lower_gpt2_block_radix(2, bits=16, msg_bits=2, seed=1)
    prog = api.Program.from_graph(g, meta["in_specs"], meta["out_specs"])
    jprog = japi.Program.from_graph(jg, jmeta["in_specs"], jmeta["out_specs"])
    width = tp.big_n + 1
    rows = {}
    for name in ("eager", "local"):
        teng, jeng = StandInEngine("cpu"), StandInEngine()
        tb = api.make_backend(name, types.SimpleNamespace(params=tp, device="cpu"), teng)
        jb = japi.make_backend(name, types.SimpleNamespace(params=jp), jeng)
        ics = [getattr(b, "int_ctx", None) or b.interp.int_ctx for b in (tb, jb)]
        for ic in ics:
            ic._polys = lambda tables: None          # shapes only: no LUT encode
        tout = tb.execute(prog, [torch.zeros((16, width), dtype=torch.int64)])
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            jout = jb.execute(jprog, [jax.numpy.zeros((16, width), jax.numpy.uint64)])
        assert tuple(tout[0].shape) == tuple(jout[0].shape) == (16, width)
        assert teng.rows == jeng.rows, name
        for key in ("pbs", "lut_batches", "batch_sizes", "dispatch_sizes"):
            assert ics[0].stats[key] == ics[1].stats[key], (name, key)
        assert (len(teng.rows), sum(teng.rows), max(teng.rows)) == (104, 2080, 96)
        assert ics[0].stats["pbs"] == 1268
        rows[name] = teng.rows
    assert rows["eager"] == rows["local"]
