"""The radix GPT-2 block, encrypted, through the port against JAX.

`lower_gpt2_block_radix(2, bits=16, msg_bits=2, seed=1)` (ct*ct
attention by exact `radix_mul`, ReLU MLP, 16-bit activations) on the
4-bit test keys: the input is encrypted by JAX's `Session` and carried
across with `u64_to_tensor`; JAX's eager backend, and the port's eager
and local backends (fused kernel backend, plain versions on the CPU),
must decrypt alike and to the exact integer oracle mod 2^16.  Served,
the reference's 3-client wave (one client a replay of another) runs
through the reference's runtime and the port's on the same inputs, with
the same fused rounds, LUT counts and dedup hits.  Tolerance: exact.
About 100 PBS rounds per backend and 47 fused rounds per wave, so this
file runs alone on an xdist worker (`--dist loadfile`) and is marked
slow as the reference's own encrypted GPT-2 tests are.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro import api as japi  # noqa: E402
from repro import serve as jserve  # noqa: E402
from repro.fhe_ml import lower as jlower, quantize as jquantize  # noqa: E402
from repro_torch import api, serve  # noqa: E402
from repro_torch.fhe_ml import lower, quantize  # noqa: E402
from repro_torch.interop import u64_to_tensor  # noqa: E402
from test_torch_api import assert_same_graph, assert_same_value, port_context  # noqa: E402
from test_torch_serve import barrier_only, sched_counts  # noqa: E402
from torch_threads import two_torch_threads  # noqa: E402,F401


@pytest.fixture(scope="module")
def block():
    """Both packages' lowered block and the quantized test input of each
    seed: {seed: (q, oracle)}."""
    g, meta = lower.lower_gpt2_block_radix(2, bits=16, msg_bits=2, seed=1)
    jg, jmeta = jlower.lower_gpt2_block_radix(2, bits=16, msg_bits=2, seed=1)
    assert_same_graph(g, jg)
    inputs = {}
    for seed in (3, 4):
        xf = np.random.default_rng(seed).uniform(-1, 1, size=(2,))
        q = quantize.quantize_to_radix(
            xf, quantize.calibrate_radix(xf, 16, 2, qmax=meta["input_qmax"]))
        jq = jquantize.quantize_to_radix(
            xf, jquantize.calibrate_radix(xf, 16, 2, qmax=jmeta["input_qmax"]))
        assert_same_value(q, jq, "q")
        inputs[seed] = (q, meta["int_fn"](q) % (1 << 16))
    return g, meta, jg, jmeta, inputs


@pytest.fixture(scope="module")
def jax_eager(ctx_4bit, engine_4bit, block):
    """Seed 3's input encrypted by JAX's Session (key 7) and decrypted
    after JAX's eager run; seed 4's input encrypted with key 8."""
    _, _, jg, jmeta, inputs = block
    with japi.Session(ctx_4bit, engine_4bit, backend="eager") as jsess:
        jprog = jsess.compile(jg, jmeta["in_specs"], jmeta["out_specs"])
        enc = jsess.encrypt_inputs(jax.random.key(7), [inputs[3][0]], jprog)
        jgot = np.asarray(jsess.decrypt_outputs(jprog, jsess.run(jprog, enc))[0])
        enc2 = jsess.encrypt_inputs(jax.random.key(8), [inputs[4][0]], jprog)
    np.testing.assert_array_equal(jgot % (1 << 16), inputs[3][1])
    return enc, jgot, enc2


@pytest.fixture(scope="module")
def tctx(ctx_4bit):
    return port_context(ctx_4bit)


@pytest.fixture(scope="module")
def port_eager(tctx, block, jax_eager):
    """The port's eager run of seed 3's JAX-encrypted input: decrypt and
    dispatch sizes."""
    g, meta, *_ = block
    sess = api.Session(tctx, backend="eager", kernel_backend="fused")
    prog = sess.compile(g, meta["in_specs"], meta["out_specs"])
    got = sess.decrypt_outputs(prog, sess.run(prog, to_port(jax_eager[0])))[0]
    return got, sess.backend.int_ctx.stats["dispatch_sizes"]


def to_port(enc) -> list:
    return [u64_to_tensor(np.asarray(e), "cpu") for e in enc]


@pytest.mark.slow
def test_encrypted_gpt2_radix_block_eager_and_local_match_jax(tctx, block, jax_eager,
                                                              port_eager):
    g, meta, *_ = block
    enc, jgot, _ = jax_eager
    got, eager_rounds = port_eager
    assert_same_value(got, jgot, "eager")
    sess = api.Session(tctx, backend="local", kernel_backend="fused")
    prog = sess.compile(g, meta["in_specs"], meta["out_specs"])
    got = sess.decrypt_outputs(prog, sess.run(prog, to_port(enc)))[0]
    assert_same_value(got, jgot, "local")
    assert eager_rounds == sess.backend.interp.int_ctx.stats["dispatch_sizes"]


@pytest.mark.slow
def test_encrypted_gpt2_radix_block_serve_matches_eager(ctx_4bit, engine_4bit, tctx,
                                                        block, jax_eager, port_eager):
    """The reference's `fhe_ml_gpt2_block` wave: three clients, the third
    a replay of the first, started paused so all three share every
    barrier.  The port's served decrypts equal its eager's, JAX's eager's
    and the oracle; its fused rounds, logical and dispatched LUTs and
    dedup hits equal the reference runtime's on the same inputs (3,804
    logical LUTs in 47 fused rounds: the replay's 1,268 PBS ride the
    original's)."""
    g, meta, jg, jmeta, inputs = block
    enc, jgot, enc2 = jax_eager
    waves = {}
    for name, runtime, graph, ctx, eng, inputs_of in (
            ("reference", jserve.ServeRuntime, jg, ctx_4bit, engine_4bit, list),
            ("port", serve.ServeRuntime, g, tctx, None, to_port)):
        rt = barrier_only(runtime(ctx, eng, max_inflight=3, start_paused=True))
        handles = [rt.submit(graph, inputs_of(e), client_id=f"client-{i}")
                   for i, e in enumerate((enc, enc2, enc))]
        rt.resume()
        rt.close()
        waves[name] = (rt, [h.outputs() for h in handles])
    counts = sched_counts(waves["port"][0])
    assert counts == sched_counts(waves["reference"][0])
    assert counts["logical_luts"] == 3 * 1268 and counts["fused_rounds"] == 47
    assert counts["dedup_hits"] >= 1268 and counts["mean_occupancy"] == 1.0
    sess = api.Session(tctx, backend="eager")
    prog = sess.compile(g, meta["in_specs"], meta["out_specs"])
    got = [sess.decrypt_outputs(prog, outs)[0] for outs in waves["port"][1]]
    assert_same_value(got[0], port_eager[0], "serve")
    assert_same_value(got[0], jgot, "serve")
    assert_same_value(got[2], jgot, "replay")
    np.testing.assert_array_equal(np.asarray(got[1]) % (1 << 16), inputs[4][1])
    with japi.Session(ctx_4bit, engine_4bit, backend="eager") as jsess:
        jprog = jsess.compile(jg, jmeta["in_specs"], jmeta["out_specs"])
        jserved = np.asarray(jsess.decrypt_outputs(jprog, waves["reference"][1][1])[0])
    assert_same_value(got[1], jserved, "client-1")
