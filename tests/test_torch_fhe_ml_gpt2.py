"""The radix GPT-2 block, encrypted, through the port against JAX.

`lower_gpt2_block_radix(2, bits=16, msg_bits=2, seed=1)` (ct*ct
attention by exact `radix_mul`, ReLU MLP, 16-bit activations) on the
4-bit test keys: the input is encrypted by JAX's `Session` and carried
across with `u64_to_tensor`; JAX's eager backend, and the port's eager
and local backends (fused kernel backend, plain versions on the CPU),
must decrypt alike and to the exact integer oracle mod 2^16.  Tolerance:
exact.  About 100 PBS rounds per backend, so this file runs alone on an
xdist worker (`--dist loadfile`) and is marked slow as the reference's
own encrypted GPT-2 tests are.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro import api as japi  # noqa: E402
from repro.fhe_ml import lower as jlower, quantize as jquantize  # noqa: E402
from repro_torch import api  # noqa: E402
from repro_torch.fhe_ml import lower, quantize  # noqa: E402
from repro_torch.interop import u64_to_tensor  # noqa: E402
from test_torch_api import assert_same_graph, assert_same_value, port_context  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def two_torch_threads():
    """Two intra-op threads: each backend's rounds are the long pole of
    its worker, and the other workers keep one thread each."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.slow
def test_encrypted_gpt2_radix_block_eager_and_local_match_jax(ctx_4bit, engine_4bit):
    g, meta = lower.lower_gpt2_block_radix(2, bits=16, msg_bits=2, seed=1)
    jg, jmeta = jlower.lower_gpt2_block_radix(2, bits=16, msg_bits=2, seed=1)
    assert_same_graph(g, jg)
    xf = np.random.default_rng(3).uniform(-1, 1, size=(2,))
    rq = quantize.calibrate_radix(xf, 16, 2, qmax=meta["input_qmax"])
    q = quantize.quantize_to_radix(xf, rq)
    jq = jquantize.quantize_to_radix(
        xf, jquantize.calibrate_radix(xf, 16, 2, qmax=jmeta["input_qmax"]))
    assert_same_value(q, jq, "q")
    want = meta["int_fn"](q) % (1 << 16)
    with japi.Session(ctx_4bit, engine_4bit, backend="eager") as jsess:
        jprog = jsess.compile(jg, jmeta["in_specs"], jmeta["out_specs"])
        enc = jsess.encrypt_inputs(jax.random.key(7), [q], jprog)
        jgot = np.asarray(jsess.decrypt_outputs(jprog, jsess.run(jprog, enc))[0])
    np.testing.assert_array_equal(jgot % (1 << 16), want)
    tctx = port_context(ctx_4bit)
    enc = [u64_to_tensor(np.asarray(e), "cpu") for e in enc]
    rounds = {}
    for backend in ("eager", "local"):
        sess = api.Session(tctx, backend=backend, kernel_backend="fused")
        prog = sess.compile(g, meta["in_specs"], meta["out_specs"])
        got = sess.decrypt_outputs(prog, sess.run(prog, enc))[0]
        assert_same_value(got, jgot, backend)
        ic = getattr(sess.backend, "int_ctx", None) or sess.backend.interp.int_ctx
        rounds[backend] = ic.stats["dispatch_sizes"]
    assert rounds["eager"] == rounds["local"]
