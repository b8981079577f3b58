"""The port's radix integers, boolean gates and noise model against JAX.

Same keys and same input ciphertexts: the JAX contexts of
`tests/conftest.py` are carried across with `context_from_numpy`, and
JAX-encrypted integers with `radix_from_numpy`.  Both port kernel
backends run (`"fused"`, which on the CPU runs each kernel's plain
version, and `"reference"`), each op on each.

Tolerances: exact equality everywhere — tables, padding, stats, round
plans, decrypts, and the bits of every LPU (linear) step — except the
noise formulas, held to 1e-12 relative.  Raw ciphertext bits are compared
only where no PBS ran: after a blind rotation the f64 transforms may
round differently, which moves the phase far less than a slot.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import integer as jint, noise as jnoise, params as jparams  # noqa: E402
from repro.core.boolean import BooleanContext as JaxBooleanContext  # noqa: E402
from repro.core.integer import IntegerContext as JaxIntegerContext  # noqa: E402
from repro_torch.compiler.ir import radix_round_plan  # noqa: E402
from repro_torch.core import integer, noise, params  # noqa: E402
from repro_torch.core.boolean import BooleanContext  # noqa: E402
from repro_torch.core.engine import TaurusEngine  # noqa: E402
from repro_torch.core.integer import IntegerContext, RadixSpec  # noqa: E402
from repro_torch.interop import (context_from_numpy, radix_from_numpy,  # noqa: E402
                                 radix_to_numpy, tensor_to_u64, u64_to_tensor)
from torch_stand_in import StandInEngine  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401

STATS = ("pbs", "lut_batches", "batch_sizes", "dispatch_sizes")


def port_context(ctx):
    arrays = {k: np.asarray(getattr(ctx, k))
              for k in ("lwe_sk", "glwe_sk", "big_sk", "ksk", "bsk_f")}
    return context_from_numpy(dataclasses.asdict(ctx.params), arrays, "cpu")


@pytest.fixture(scope="module")
def tctx(ctx_2bit, ctx_4bit):
    return {"ic2": port_context(ctx_2bit), "ic4": port_context(ctx_4bit)}


@pytest.fixture(scope="module")
def jics(ctx_2bit, ctx_4bit, engine_2bit, engine_4bit):
    return {"ic2": JaxIntegerContext.create(ctx_2bit, engine_2bit),
            "ic4": JaxIntegerContext.create(ctx_4bit, engine_4bit)}


def port_ic(tctx, which, backend):
    ctx = tctx[which]
    return IntegerContext.create(ctx, TaurusEngine.from_context(
        ctx, kernel_backend=backend, device="cpu"))


def carry(jrct):
    """A JAX RadixCiphertext as the port's, same bits."""
    return radix_from_numpy(dataclasses.asdict(jrct.spec), np.asarray(jrct.digits), "cpu")


# --- digit layout and tables ------------------------------------------------------

@pytest.mark.parametrize("name", ["TEST_PARAMS", "TEST_PARAMS_4BIT", "TEST_PARAMS_6BIT"])
@pytest.mark.parametrize("bits", [8, 16, 32])
def test_spec_layout_and_digits_match(name, bits):
    jp, tp = getattr(jparams, name), getattr(params, name)
    for m in range(1, tp.width // 2 + 1):
        if bits % m:
            continue
        js, ts = jint.RadixSpec.create(jp, bits, m), RadixSpec.create(tp, bits, m)
        assert (ts.base, ts.n_digits, ts.modulus) == (js.base, js.n_digits, js.modulus)
        for v in (0, 1, 0xBEEF, (1 << bits) - 1, -1234, 0xDEADBEEF):
            assert np.array_equal(ts.to_digits(v), js.to_digits(v))
            assert ts.to_digits(v).dtype == js.to_digits(v).dtype == np.uint64
            assert ts.from_digits(ts.to_digits(v)) == js.from_digits(js.to_digits(v))
        carried = np.arange(ts.n_digits, dtype=np.uint64) * 3
        assert ts.from_digits(carried) == js.from_digits(carried)
    if bits % (tp.width // 2) == 0:
        assert RadixSpec.create(tp, bits).msg_bits == jint.RadixSpec.create(jp, bits).msg_bits


TABLES = [("msg_table", True), ("carry_table", True), ("sigma_table", True),
          ("generate_table", True), ("propagate_bit_table", True),
          ("cmp_digit_table", True), ("sign_table", True), ("mask_table", True),
          ("status_carry_table", False), ("status_id_table", False),
          ("bit_and_table", False), ("bit_or_table", False),
          ("cmp_combine_table", False)]


@pytest.mark.parametrize("name,takes_msg", TABLES, ids=[t[0] for t in TABLES])
@pytest.mark.parametrize("width", [2, 4, 6, 8])
def test_tables_bit_identical(name, takes_msg, width):
    for m in (range(1, width // 2 + 1) if takes_msg else [None]):
        args = (width, m) if takes_msg else (width,)
        got, want = getattr(integer, name)(*args), getattr(jint, name)(*args)
        assert got.dtype == want.dtype and np.array_equal(got, want), (name, args)


@pytest.mark.parametrize("width", [2, 4, 6, 8])
def test_pair_tables_and_padding_bit_identical(width):
    for m in range(1, width // 2 + 1):
        for hi in (False, True):
            assert np.array_equal(integer.pp_table(width, m, hi), jint.pp_table(width, m, hi))
    for to_carry in (False, True):
        assert np.array_equal(integer.combine_table(width, to_carry),
                              jint.combine_table(width, to_carry))
    assert [integer._pad_batch(b) for b in range(1, 600)] == \
        [jint._pad_batch(b) for b in range(1, 600)]


# --- the LPU dataflow, bit for bit ----------------------------------------------------

def record_luts(ic, unpack):
    """Replace `ic._lut` with an identity that records every round's
    input bits and tables: each op then runs its whole linear dataflow
    with no PBS, so both packages can be compared bit for bit."""
    calls = []

    def lut(cts, tables):
        calls.append((unpack(cts), np.asarray(tables, dtype=np.uint64)))
        return cts
    ic._lut = lut
    return calls


def lpu_ops(ic, a, b, W, xs):
    return {"add": lambda: ic.add(a, b).digits,
            "sub": lambda: ic.sub(a, b).digits,
            "mul": lambda: ic.mul(a, b).digits,
            "mul_digit": lambda: ic.mul_digit(a, b.digits[0]).digits,
            "compare": lambda: ic.compare(a, b),
            "relu_clamp": lambda: ic.relu_clamp(a).digits,
            "linear_compress": lambda: ic.linear_compress(xs, W, a.spec)[0],
            "trivial_digits": lambda: ic._trivial_digits(a.spec, a.spec.base - 1)}


@pytest.mark.parametrize("op", ["add", "sub", "mul", "mul_digit", "compare",
                                "relu_clamp", "linear_compress", "trivial_digits"])
def test_lpu_dataflow_bit_identical(ctx_4bit, engine_4bit, tctx, op):
    """Every linear step — scalar multiples by base and 4, the base
    complement with its trivial digits, the +delta at the LSB, the signed
    weights and negative plaintext sums of `linear_compress`, the sign
    broadcast of `relu_clamp` — wraps mod 2^64 exactly as JAX's uint64
    does, on carried-across ciphertexts, round for round."""
    jic = JaxIntegerContext.create(ctx_4bit, engine_4bit)
    tic = port_ic(tctx, "ic4", "fused")
    ja = jic.encrypt(jax.random.key(11), 0xBEEF, 16)
    jb = jic.encrypt(jax.random.key(12), 0x9A3C, 16)
    xs_j = jnp.stack([jic.encrypt(jax.random.key(20 + i), v, 16).digits
                      for i, v in enumerate((0x0123, 0xFFFF, 0x8001))])
    W = np.array([[1, -3, 0], [2, -1, -1], [0, 5, -2]], np.int64)
    jcalls = record_luts(jic, lambda c: np.asarray(c))
    tcalls = record_luts(tic, tensor_to_u64)
    want = np.asarray(lpu_ops(jic, ja, jb, W, xs_j)[op]())
    got = tensor_to_u64(lpu_ops(tic, carry(ja), carry(jb), W,
                                u64_to_tensor(np.asarray(xs_j), "cpu"))[op]())
    assert np.array_equal(got, want)
    assert len(tcalls) == len(jcalls) and (op == "trivial_digits" or jcalls)
    for (tc, tt), (jc, jt) in zip(tcalls, jcalls):
        assert np.array_equal(tc, jc) and np.array_equal(tt, jt)


def test_engine_linear_ops_bit_identical(ctx_2bit, engine_2bit, tctx):
    from repro.core.engine import TaurusEngine as JaxEngine
    p = ctx_2bit.params
    je, te = JaxEngine.from_context(ctx_2bit), TaurusEngine.from_context(tctx["ic2"],
                                                                         device="cpu")
    a = jnp.asarray(np.random.default_rng(3).integers(0, 2 ** 64, (5, p.big_n + 1),
                                                      dtype=np.uint64))
    b = jnp.asarray(np.random.default_rng(4).integers(0, 2 ** 64, (5, p.big_n + 1),
                                                      dtype=np.uint64))
    ta, tb = u64_to_tensor(np.asarray(a), "cpu"), u64_to_tensor(np.asarray(b), "cpu")
    pairs = [(te.add(ta, tb), je.add(a, b)), (te.sub(ta, tb), je.sub(a, b)),
             (te.scalar_mul(ta, 7), je.scalar_mul(a, 7)),
             (te.add_plain(ta, 3), je.add_plain(a, 3)),
             (te.trivial(torch.tensor([0, 1, 3])), je.trivial(np.array([0, 1, 3])))]
    for got, want in pairs:
        assert np.array_equal(tensor_to_u64(got), np.asarray(want))
    assert (te.batch_size, te.n_clusters, te.supports_ks_split) == \
        (je.batch_size, je.n_clusters, je.supports_ks_split)


# --- decrypts and stats against JAX and the oracle -------------------------------------

def _relu(v, bits):
    v %= 1 << bits
    return 0 if v >= 1 << (bits - 1) else v


# name -> (context, port backend, bits, op, a, b, oracle): the carry-boundary
# cases of tests/test_integer.py and each op on each port backend.  A case
# runs on one backend: a PBS round costs ~0.5-1 s of CPU at the 4-bit
# parameters, and the two backends are held to each other round for round
# in tests/test_torch_engine.py.
CASES = {
    "add16_wrap": ("ic4", "fused", 16, "add", 0xFFFF, 1, 0),
    "add16_prefix": ("ic4", "reference", 16, "add", 0xBEEF, 0x1234, 0xD123),
    "sub16": ("ic4", "fused", 16, "sub", 0x1234, 0xBEEF, (0x1234 - 0xBEEF) % 2 ** 16),
    "mul8": ("ic4", "fused", 8, "mul", 0xB7, 0x59, (0xB7 * 0x59) % 2 ** 8),
    "mul8_wrap": ("ic4", "reference", 8, "mul", 0xFF, 0xFE, (0xFF * 0xFE) % 2 ** 8),
    "cmp16_gt": ("ic4", "fused", 16, "compare", 0xBEEF, 0x1234, 2),
    "cmp8_eq": ("ic4", "reference", 8, "compare", 0x34, 0x34, 0),
    "relu16_neg": ("ic4", "fused", 16, "relu_clamp", -1234, None, 0),
    "relu16_pos": ("ic4", "reference", 16, "relu_clamp", 0x7FFF, None, 0x7FFF),
    "add16_lookahead_wrap": ("ic2", "fused", 16, "add", 0xFFFF, 1, 0),
    "add16_lookahead_msb": ("ic2", "reference", 16, "add", 0x7FFF, 1, 0x8000),
    "add16_lookahead_propagate": ("ic2", "fused", 16, "add", 0xAAAA, 0x5555, 0xFFFF),
    "add8_ripple": ("ic2", "fused", 8, "add", 173, 209, (173 + 209) % 256),
    "sub8_ripple": ("ic2", "reference", 8, "sub", 0x00, 0x01, 0xFF),
    "mul8_base2": ("ic2", "reference", 8, "mul", 171, 206, (171 * 206) % 256),
}


def run_op(ic, op, a, b):
    if op == "relu_clamp":
        return ic.relu_clamp(a)
    return getattr(ic, op)(a, b)


def decrypt_result(ic, out):
    """(value, per-digit decrypts) of an op's result."""
    if isinstance(out, (jint.RadixCiphertext, integer.RadixCiphertext)):
        return ic.decrypt(out), [int(d) for d in ic.decrypt_digits(out)]
    return int(ic.ctx.decrypt(out)), None


@pytest.mark.parametrize("name", list(CASES))
def test_ops_decrypt_and_stats_identical(tctx, jics, name):
    """The same JAX-encrypted inputs through JAX and the port: equal
    decrypts (the value and every digit), both equal to the oracle, and
    equal stats (logical and dispatched rounds and rows)."""
    which, backend, bits, op, a, b, oracle = CASES[name]
    jic = jics[which]
    seed = sum(map(ord, name))
    ja = jic.encrypt(jax.random.key(seed), a, bits)
    jb = None if b is None else jic.encrypt(jax.random.key(seed + 1), b, bits)
    jic.reset_stats()
    jval, jdigits = decrypt_result(jic, run_op(jic, op, ja, jb))
    ic = port_ic(tctx, which, backend)
    out = run_op(ic, op, carry(ja), None if jb is None else carry(jb))
    val, digits = decrypt_result(ic, out)
    assert val == jval == oracle
    assert digits == jdigits
    if digits is not None and op != "relu_clamp":
        assert max(digits) < ic.spec(bits).base        # fully propagated
    assert {k: ic.stats[k] for k in STATS} == {k: jic.stats[k] for k in STATS}


def shape_only(ic):
    """`ic` on a StandInEngine, without encoding LUT polynomials."""
    ic._polys = lambda tables: None
    return ic


@pytest.mark.parametrize("which,bits,strategy", [("ic2", 16, "lookahead"),
                                                 ("ic2", 8, "ripple"),
                                                 ("ic4", 16, "prefix")])
def test_round_plan_matches_observed_stats(tctx, jics, which, bits, strategy):
    """The port's `radix_round_plan` and its `IntegerContext` agree round
    for round, and both agree with JAX's stats, for the strategy each
    width auto-selects (the cases of tests/test_integer.py; the decrypts
    of such adds are held above)."""
    mask = (1 << bits) - 1
    jic = shape_only(JaxIntegerContext(jics[which].ctx, StandInEngine()))
    ja = jic.encrypt(jax.random.key(301), 0xBEEF & mask, bits)
    jb = jic.encrypt(jax.random.key(302), 0x1234 & mask, bits)
    jic.add(ja, jb)
    ic = shape_only(IntegerContext(tctx[which], StandInEngine()))
    ic.add(carry(ja), carry(jb))
    spec = ic.spec(bits)
    plan = radix_round_plan("radix_add", spec.n_digits, spec.msg_bits)
    assert ic.stats["lut_batches"] == len(plan) == jic.stats["lut_batches"], strategy
    assert ic.stats["batch_sizes"] == [r["luts"] for r in plan] == jic.stats["batch_sizes"]
    assert ic.stats["dispatch_sizes"] == jic.stats["dispatch_sizes"]
    assert ic.stats["pbs"] == jic.stats["pbs"] == sum(r["luts"] for r in plan)


SHAPE_CASES = [(which, bits, op) for which, bits in (("ic4", 8), ("ic4", 16), ("ic4", 32),
                                                     ("ic2", 8))
               for op in ("mul", "compare", "relu_clamp", "sub")
               if not (op == "compare" and which == "ic2")]   # compare needs width 4


@pytest.mark.parametrize("which,bits,op", SHAPE_CASES)
def test_rounds_match_reference_runtime(tctx, jics, which, bits, op):
    """Every op's rounds on shapes alone, port against JAX, row for row.
    (The reference's `radix_round_plan` counts 1 + ceil(log2 D) + 1
    multiply rounds; both runtimes run D, from D = 8 on more than the
    plan: the carry-save compression retires one column a round.)"""
    jic = shape_only(JaxIntegerContext(jics[which].ctx, StandInEngine()))
    ic = shape_only(IntegerContext(tctx[which], StandInEngine()))
    spec = ic.spec(bits)
    w = ic.params.big_n + 1
    jz = jint.RadixCiphertext(jint.RadixSpec.create(jic.params, bits),
                              jnp.zeros((spec.n_digits, w), dtype=jnp.uint64))
    tz = integer.RadixCiphertext(spec, torch.zeros((spec.n_digits, w), dtype=torch.int64))
    run_op(jic, op, jz, jz)
    run_op(ic, op, tz, tz)
    assert {k: ic.stats[k] for k in STATS} == {k: jic.stats[k] for k in STATS}
    if op == "mul":
        assert ic.stats["lut_batches"] == spec.n_digits


# --- the port's own encryption and interop ---------------------------------------------

@pytest.mark.parametrize("bits", [8, 16, 32])
def test_own_encrypt_decrypt_roundtrip(tctx, bits):
    ic = port_ic(tctx, "ic4", "fused")
    gen = torch.Generator().manual_seed(bits)
    for v in (0, 1, 0xDEADBEEF % (1 << bits), (1 << bits) - 1):
        ct = ic.encrypt(gen, v, bits)
        assert ic.decrypt(ct) == v and ct.digits.shape[0] == bits // ct.spec.msg_bits
        noise_ = ic.digit_noise(ct, v)
        assert np.max(np.abs(noise_)) < 1.0 / 2 ** (ic.params.width + 2)


def test_radix_interop_roundtrip(jics):
    jrct = jics["ic4"].encrypt(jax.random.key(5), 0xBEEF, 16)
    rct = carry(jrct)
    fields, digits = radix_to_numpy(rct)
    assert fields == dataclasses.asdict(jrct.spec)
    assert np.array_equal(digits, np.asarray(jrct.digits))
    assert rct.spec == RadixSpec.create(params.TEST_PARAMS_4BIT, 16)


def test_poly_stacks_cached_on_engine_device(tctx):
    ic = port_ic(tctx, "ic2", "fused")
    tables = np.tile(integer.msg_table(2, 1), (16, 1))
    first = ic._polys(tables)
    assert ic._polys(tables.copy()) is first
    assert first.device == ic.engine.device and first.shape == (16, ic.params.N)


# --- boolean gates ------------------------------------------------------------------

def record_sign_pbs(bctx, unpack):
    """Replace the sign bootstrap with an identity that records its input
    bits: the gates' linear combinations compared with no PBS."""
    calls = []

    def sign_pbs(cts):
        calls.append(unpack(cts))
        return cts
    bctx._sign_pbs = sign_pbs
    return calls


def boolean_inputs(jb, n_sets, bits, seed):
    key = jax.random.PRNGKey(seed)
    return [jnp.stack([jb.encrypt(jax.random.fold_in(key, 10 * k + i), v)
                       for i, v in enumerate(bits[k])]) for k in range(n_sets)]


def test_boolean_gates_match(ctx_2bit, tctx):
    """Every gate decrypts to its truth table on JAX-encrypted bits, and
    its pre-bootstrap linear combination is JAX's bit for bit."""
    bits = ([0, 0, 1, 1], [0, 1, 0, 1], [1, 0, 0, 1])
    jb = JaxBooleanContext(ctx_2bit)
    enc = boolean_inputs(jb, 3, bits, 0)
    tb = BooleanContext(tctx["ic2"])
    ta, tbb, tc = (u64_to_tensor(np.asarray(e), "cpu") for e in enc)
    a, b, c = (np.array(x) for x in bits)
    truth = {"and_": a & b, "or_": a | b, "xor": a ^ b, "nand": 1 - (a & b)}
    for gate, want in truth.items():
        assert tb.decrypt(getattr(tb, gate)(ta, tbb)).tolist() == want.tolist(), gate
    assert tb.decrypt(tb.maj(ta, tbb, tc)).tolist() == (a + b + c >= 2).astype(int).tolist()
    assert tb.decrypt(tb.not_(ta)).tolist() == (1 - a).tolist()
    assert tb.decrypt(ta).tolist() == np.asarray(jb.decrypt(enc[0])).tolist() == a.tolist()
    jcalls = record_sign_pbs(jb, lambda x: np.asarray(x))
    tcalls = record_sign_pbs(tb, tensor_to_u64)
    for gate in truth:
        getattr(jb, gate)(enc[0], enc[1])
        getattr(tb, gate)(ta, tbb)
    jb.maj(*enc)
    tb.maj(ta, tbb, tc)
    assert len(tcalls) == len(jcalls) == 5
    assert all(np.array_equal(t, j) for t, j in zip(tcalls, jcalls))
    assert np.array_equal(tensor_to_u64(tb.not_(ta)), np.asarray(jb.not_(enc[0])))
    assert tb.bootstraps_per_add_bit == jb.bootstraps_per_add_bit


def test_boolean_add_ripple_matches(ctx_2bit, tctx):
    """The ripple-carry adder adds (3 bootstraps per bit), and its gate
    inputs are JAX's bit for bit with the bootstrap stubbed out."""
    a, b, n = 11, 6, 4
    jb = JaxBooleanContext(ctx_2bit)
    enc = boolean_inputs(jb, 2, [[(v >> i) & 1 for i in range(n)] for v in (a, b)], 1)
    tb = BooleanContext(tctx["ic2"])
    targs = [u64_to_tensor(np.asarray(e), "cpu") for e in enc]
    got = tb.decrypt(tb.add_ripple(*targs)).tolist()
    assert sum(int(v) << i for i, v in enumerate(got)) == a + b
    jcalls = record_sign_pbs(jb, lambda x: np.asarray(x))
    tcalls = record_sign_pbs(tb, tensor_to_u64)
    want = np.asarray(jb.add_ripple(*enc))
    assert np.array_equal(tensor_to_u64(tb.add_ripple(*targs)), want)
    assert len(tcalls) == len(jcalls) == n * tb.bootstraps_per_add_bit - 1
    assert all(np.array_equal(t, j) for t, j in zip(tcalls, jcalls))


# --- noise model ---------------------------------------------------------------------

NOISE_SETS = list(params.PAPER_PARAMS) + ["TEST_PARAMS", "TEST_PARAMS_4BIT",
                                          "TEST_PARAMS_6BIT", "TEST_PARAMS_K2"]


@pytest.mark.parametrize("name", NOISE_SETS)
def test_noise_model_matches(name):
    if name in params.PAPER_PARAMS:
        tp, jp = params.PAPER_PARAMS[name], jparams.PAPER_PARAMS[name]
    else:
        tp, jp = getattr(params, name), getattr(jparams, name)

    def close(got, want):
        return abs(got - want) <= 1e-12 * abs(want)

    v = jnoise.pbs_out_var(jp)
    pairs = [(noise.fresh_var(tp), jnoise.fresh_var(jp)),
             (noise.keyswitch_var(tp, v), jnoise.keyswitch_var(jp, v)),
             (noise.modswitch_var(tp, v), jnoise.modswitch_var(jp, v)),
             (noise.pbs_out_var(tp), v),
             (noise.pre_rotation_std(tp, v), jnoise.pre_rotation_std(jp, v)),
             (noise.failure_prob(tp), jnoise.failure_prob(jp)),
             (noise.failure_prob(tp, 1e-12), jnoise.failure_prob(jp, 1e-12)),
             (noise.log2_failure_prob(tp), jnoise.log2_failure_prob(jp)),
             (noise.log2_failure_prob(tp, 3), jnoise.log2_failure_prob(jp, 3))]
    for i, (got, want) in enumerate(pairs):
        assert close(got, want), (name, i, got, want)
    assert noise.radix_width(tp) == jnoise.radix_width(jp)
