"""The port's engine (`repro_torch.core.engine`) against the JAX engine.

JAX-made keys and ciphertexts are carried across with
`repro_torch.interop`; both port backends (`"fused"`, which on the CPU
runs each kernel's plain version, and `"reference"`) must decrypt
exactly as the JAX engine does.  Raw GLWE masks are not compared after
the first CMux step: f64 transform rounding may flip a gadget digit at
a rounding boundary while the phase moves far less than delta.
"""
import contextlib
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import glwe as jglwe  # noqa: E402
from repro_torch.core import glwe  # noqa: E402
from repro_torch.core.engine import TaurusEngine, validate_lut_tables  # noqa: E402
from repro_torch.interop import context_from_numpy, tensor_to_u64, u64_to_tensor  # noqa: E402
from repro_torch.kernels import launch_counts, reset_launch_counts  # noqa: E402

BACKENDS = ["fused", "reference"]


def port_context(ctx):
    arrays = {k: np.asarray(getattr(ctx, k))
              for k in ("lwe_sk", "glwe_sk", "big_sk", "ksk", "bsk_f")}
    return context_from_numpy(dataclasses.asdict(ctx.params), arrays, "cpu")


@pytest.fixture(scope="module")
def tctx_2bit(ctx_2bit):
    return port_context(ctx_2bit)


@pytest.fixture(scope="module")
def tctx_4bit(ctx_4bit):
    return port_context(ctx_4bit)


@pytest.fixture(scope="module")
def engines_2bit(tctx_2bit):
    return {b: TaurusEngine.from_context(tctx_2bit, kernel_backend=b, device="cpu")
            for b in BACKENDS}


def jax_cts(ctx, B, seed=97):
    key = jax.random.PRNGKey(seed)
    msgs = np.arange(B) % ctx.params.plaintext_modulus
    cts = jnp.stack([ctx.encrypt(jax.random.fold_in(key, i), int(m))
                     for i, m in enumerate(msgs)])
    return cts, msgs


def decrypt_identical(ctx, jengine, tctx, tengines, B, table, seed=97):
    """Run one lut_batch on the JAX engine and every port engine from the
    same JAX ciphertexts; return the decryptions, JAX's first."""
    p = ctx.params
    cts, msgs = jax_cts(ctx, B, seed)
    polys = jnp.broadcast_to(jglwe.make_lut_poly(jnp.asarray(table, dtype=jnp.uint64), p),
                             (B, p.N))
    want = [int(ctx.decrypt(v)) for v in jengine.lut_batch(cts, polys)]
    tcts = u64_to_tensor(np.asarray(cts), "cpu")
    tpolys = u64_to_tensor(np.asarray(polys), "cpu")
    got = [tctx.decrypt(e.lut_batch(tcts, tpolys)).tolist() for e in tengines]
    return want, got, [table[int(m)] for m in msgs]


@pytest.mark.parametrize("B", [1, 5, 12])
def test_lut_batch_decrypt_identical_2bit(ctx_2bit, engine_2bit, tctx_2bit,
                                          engines_2bit, B):
    table = [(3 * v + 1) % 4 for v in range(4)]
    want, got, plain = decrypt_identical(ctx_2bit, engine_2bit, tctx_2bit,
                                         list(engines_2bit.values()), B, table)
    assert want == plain
    assert got == [want, want]


def test_lut_batch_decrypt_identical_4bit(ctx_4bit, engine_4bit, tctx_4bit):
    table = [(v * v) % 16 for v in range(16)]
    engines = [TaurusEngine.from_context(tctx_4bit, kernel_backend=b, device="cpu")
               for b in BACKENDS]
    want, got, plain = decrypt_identical(ctx_4bit, engine_4bit, tctx_4bit, engines,
                                         6, table, seed=5)
    assert want == plain
    assert got == [want, want]


@pytest.mark.parametrize("backend", BACKENDS)
def test_keyswitch_then_lut_batch_small_equals_lut_batch(ctx_2bit, tctx_2bit,
                                                         engines_2bit, backend):
    eng = engines_2bit[backend]
    cts, _ = jax_cts(ctx_2bit, 5, seed=4)
    tcts = u64_to_tensor(np.asarray(cts), "cpu")
    polys = glwe.make_lut_polys_cached([[1, 2, 3, 0]] * 5, tctx_2bit.params)
    whole = eng.lut_batch(tcts, polys)
    split = eng.lut_batch_small(eng.keyswitch(tcts), polys)
    assert torch.equal(whole, split)


def test_backends_share_the_keyswitch_bits(tctx_2bit, engines_2bit, ctx_2bit):
    cts, _ = jax_cts(ctx_2bit, 7, seed=8)
    tcts = u64_to_tensor(np.asarray(cts), "cpu")
    assert torch.equal(engines_2bit["fused"].keyswitch(tcts),
                       engines_2bit["reference"].keyswitch(tcts))


def test_chained_rounds_through_one_pack(ctx_2bit, tctx_2bit, engines_2bit):
    eng = engines_2bit["fused"]
    pack0 = eng.fused_pack
    cts, msgs = jax_cts(ctx_2bit, 4, seed=21)
    out = u64_to_tensor(np.asarray(cts), "cpu")
    reset_launch_counts()
    for _ in range(3):
        out = eng.lut_batch_tables(out, [1, 2, 3, 0])
        assert eng.fused_pack is pack0
        assert eng.fused_pack.bsk_planes is pack0.bsk_planes
    assert tctx_2bit.decrypt(out).tolist() == [(int(m) + 3) % 4 for m in msgs]
    assert set(launch_counts().values()) == {0}     # CPU: plain versions only


def test_engines_of_one_key_share_one_pack(ctx_2bit, tctx_2bit, engines_2bit):
    """Every fused engine and Session of one context reads one resident
    pack; another context (here a copy of the same keys) gets its own."""
    from repro_torch.api import Session
    pack = engines_2bit["fused"].fused_pack
    again = TaurusEngine.from_context(tctx_2bit, device="cpu")
    sessions = [Session(tctx_2bit, backend=b, kernel_backend="fused") for b in ("eager", "local")]
    assert again is not engines_2bit["fused"] and again.fused_pack is pack
    assert all(s.engine.fused_pack is pack for s in sessions)
    other = port_context(ctx_2bit)
    assert TaurusEngine.from_context(other, device="cpu").fused_pack is not pack


def test_key_bytes_and_bytes_streamed(engine_2bit, pallas_engine_2bit, engines_2bit):
    for eng in engines_2bit.values():
        assert eng.key_bytes == engine_2bit.key_bytes
    pack = engines_2bit["fused"].fused_pack
    assert pack.resident_key_bytes == pallas_engine_2bit.fused_pack.resident_key_bytes
    assert pack.bytes_streamed_per_round(4) == 3_477_568
    assert pack.bytes_streamed_per_round(12) == 3_576_000
    for B in (1, 4, 12, 48):
        assert pack.bytes_streamed_per_round(B) == \
            pallas_engine_2bit.fused_pack.bytes_streamed_per_round(B)


def test_lut_batch_tables_validation(tctx_2bit, engines_2bit):
    cts = torch.zeros((3, tctx_2bit.params.big_n + 1), dtype=torch.int64)
    assert validate_lut_tables(cts, [0, 1, 2, 3], tctx_2bit.params).shape == (3, 4)
    with pytest.raises(ValueError, match="3 ciphertexts but 2 tables"):
        validate_lut_tables(cts, [[0, 1, 2, 3]] * 2, tctx_2bit.params)
    with pytest.raises(ValueError, match=r"\(B, 4\)"):
        validate_lut_tables(cts, [0, 1, 2], tctx_2bit.params)
    with pytest.raises(ValueError, match="LUT polynomials"):
        engines_2bit["reference"].lut_batch(cts, torch.zeros((2, 512), dtype=torch.int64))


def test_engine_construction_errors(tctx_2bit, monkeypatch):
    with pytest.raises(ValueError, match="kernel_backend"):
        TaurusEngine.from_context(tctx_2bit, kernel_backend="pallas", device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TaurusEngine.from_context(tctx_2bit)


class _Telemetry:
    def __init__(self):
        self.spans, self.counts, self.observed = [], {}, []

    @contextlib.contextmanager
    def span(self, name, **kw):
        self.spans.append((name, kw))
        yield

    def counter(self, name):
        tel = self

        class C:
            def inc(self, v=1):
                tel.counts[name] = tel.counts.get(name, 0) + v
        return C()

    def histogram(self, name):
        tel = self

        class H:
            def observe(self, v):
                tel.observed.append((name, v))
        return H()


def test_telemetry_hook(tctx_2bit):
    tel = _Telemetry()
    eng = TaurusEngine.from_context(tctx_2bit, kernel_backend="reference",
                                    device="cpu", telemetry=tel)
    cts = tctx_2bit.encrypt(torch.Generator().manual_seed(1), torch.arange(3))
    eng.lut_batch_small(eng.keyswitch(cts), glwe.make_lut_polys_cached(
        [[0, 1, 2, 3]] * 3, tctx_2bit.params))
    # the keyswitch runs under a span of its own and adds no counter
    assert tel.spans == [("keyswitch", {"cat": "engine", "rows": 3}),
                         ("lut_batch_small", {"cat": "engine", "rows": 3})]
    assert tel.counts == {"engine.lut_batches_reference": 1, "engine.lut_batches": 1,
                          "engine.pbs_rows": 3}
    assert tel.observed == [("engine.lut_batch_rows", 3)]


def test_context_round_trip_through_numpy(ctx_2bit, tctx_2bit):
    for name in ("lwe_sk", "glwe_sk", "big_sk", "ksk"):
        assert np.array_equal(tensor_to_u64(getattr(tctx_2bit, name)),
                              np.asarray(getattr(ctx_2bit, name)))
    assert np.array_equal(tctx_2bit.bsk_f.numpy(), np.asarray(ctx_2bit.bsk_f))


# --- the XPU baseline: no BSK reuse across ciphertexts ------------------------------

@pytest.fixture(scope="module")
def xpu_inputs(ctx_2bit, engine_2bit):
    """Four JAX-encrypted ciphertexts under the identity table, with the
    JAX engine's `lut_batch_xpu` decrypts (the counterpart of
    tests/test_engine.py's batched-versus-XPU test)."""
    p = ctx_2bit.params
    cts, msgs = jax_cts(ctx_2bit, 4, seed=42)
    polys = jnp.broadcast_to(jglwe.make_lut_poly(jnp.arange(4, dtype=jnp.uint64), p),
                             (4, p.N))
    want = [int(ctx_2bit.decrypt(v)) for v in engine_2bit.lut_batch_xpu(cts, polys)]
    assert want == [int(m) for m in msgs]
    return (u64_to_tensor(np.asarray(cts), "cpu"), u64_to_tensor(np.asarray(polys), "cpu"),
            want)


@pytest.mark.parametrize("backend", BACKENDS)
def test_lut_batch_xpu_decrypts_as_lut_batch_and_jax(tctx_2bit, engines_2bit, xpu_inputs,
                                                     backend):
    """On both backends the per-ciphertext loop decrypts as the batched
    round and as the JAX engine's `lut_batch_xpu` (exact); on the CPU the
    fused backend launches no kernel."""
    eng = engines_2bit[backend]
    cts, polys, want = xpu_inputs
    reset_launch_counts()
    xpu = eng.lut_batch_xpu(cts, polys)
    assert set(launch_counts().values()) == {0}
    assert xpu.shape == cts.shape and xpu.dtype == torch.int64
    assert tctx_2bit.decrypt(xpu).tolist() == want
    assert tctx_2bit.decrypt(eng.lut_batch(cts, polys)).tolist() == want
    with pytest.raises(ValueError, match="lut_batch_xpu: 4 ciphertexts but 3 LUT"):
        eng.lut_batch_xpu(cts, polys[:3])


def test_lut_batch_xpu_rows_are_one_row_rounds(engines_2bit, xpu_inputs):
    """The fused backend's XPU pass is one one-row round per ciphertext:
    bit for bit each row's own `lut_batch`, and the plain loop on the
    reference backend is bit for bit `core.pbs.pbs` per row."""
    from repro_torch.core import batch, pbs
    cts, polys, _ = xpu_inputs
    fused = engines_2bit["fused"]
    xpu = fused.lut_batch_xpu(cts, polys)
    for i in range(cts.shape[0]):
        assert torch.equal(xpu[i:i + 1], fused.lut_batch(cts[i:i + 1], polys[i:i + 1]))
    ref = engines_2bit["reference"]
    loop = batch.pbs_unbatched_loop(cts, polys, ref.bsk_f, ref.ksk, ref.params)
    assert torch.equal(loop[1], pbs.pbs(cts[1], polys[1], ref.bsk_f, ref.ksk, ref.params))
    assert torch.equal(ref.lut_batch_xpu(cts, polys), loop)


def test_lut_batch_xpu_telemetry(tctx_2bit, xpu_inputs):
    tel = _Telemetry()
    eng = TaurusEngine.from_context(tctx_2bit, device="cpu", telemetry=tel)
    cts, polys, _ = xpu_inputs
    eng.lut_batch_xpu(cts, polys)
    assert tel.spans == [("lut_batch_xpu", {"cat": "engine", "rows": 4})]
    assert tel.counts == {"engine.lut_batches_fused": 1, "engine.lut_batches": 1,
                          "engine.pbs_rows": 4}
    assert tel.observed == [("engine.lut_batch_rows", 4)]
