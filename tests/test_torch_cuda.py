"""The port's CUDA kernels against their plain PyTorch versions, on a card.

These tests need a CUDA device and skip without one.  The machine with
the card has no JAX, and `tests/conftest.py` imports it, so run them
there without the conftest:

    python -m pytest -q --noconftest tests/test_torch_cuda.py

Tolerances are the contract's: the keyswitch MAC bit-exact (int8
digits against the key's limb operand), the FFTs within 1e-12 of the
output scale, the MAC within 1e-9 relative, and the torus output of
`fft_inverse_torus` within 1e-12 of the float inverse's scale plus one
(the f64 transform's rounding, then one torus unit);
PBS rounds and radix integer ops decrypt exactly to their oracles.
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.compiler.ir import radix_round_plan  # noqa: E402
from repro_torch.core.engine import TaurusEngine  # noqa: E402
from repro_torch.core.integer import IntegerContext  # noqa: E402
from repro_torch.core.params import TEST_PARAMS, TEST_PARAMS_4BIT, TEST_PARAMS_K2  # noqa: E402
from repro_torch.core import torus  # noqa: E402
from repro_torch.core.pbs import TFHEContext  # noqa: E402
from repro_torch.kernels import external_product, fourstep_fft, keyswitch  # noqa: E402
from repro_torch.kernels import launch_counts, reset_launch_counts  # noqa: E402


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.Generator(device="cuda").manual_seed(7)


def close(got, want, rel):
    return (got - want).abs().max().item() <= rel * want.abs().max().item()


ROWS = [1, 12, 13, 33, 288]


@pytest.mark.parametrize("S,T", [(64, 33), (5000, 1004), (1023, 129), (70000, 7)])
@pytest.mark.parametrize("B", ROWS + [20, 100, 300])
def test_keyswitch_mac_bit_exact(gen, B, S, T):
    """Random int8 digits and int64 key words at the contract's row counts
    and in every row tier of the kernel (16, 32, 64, 144, 288, and two
    row groups at 300), with S and T off the kernel's tiles (S = 70,000
    spans two int32 stretches)."""
    d = torch.randint(-128, 128, (B, S), generator=gen, device="cuda").to(torch.int8)
    k = torch.randint(-(1 << 62), 1 << 62, (S, T), generator=gen, device="cuda") * 3
    limbs = keyswitch.ksk_limbs(k)
    reset_launch_counts()
    got = keyswitch.keyswitch_mac(d, limbs)
    assert launch_counts()["keyswitch_mac"] == 1
    assert torch.equal(got, keyswitch.keyswitch_mac_plain(d, limbs))


@pytest.mark.parametrize("digit", [-128, 127])
def test_keyswitch_mac_extremes(gen, digit):
    """The largest limb sums there are over S = 2 stretches + 48: extreme
    digits against all-ones and high-bit key words."""
    S, T = 2 * keyswitch.STRETCH + 48, 5
    d = torch.full((13, S), digit, dtype=torch.int8, device="cuda")
    d[1::2, ::5] = 0
    k = torch.full((S, T), -1, dtype=torch.int64, device="cuda")
    k[:, 1] = -(1 << 63)
    k[::3, 2] = 0x7F00FF00FF00FF00
    limbs = keyswitch.ksk_limbs(k)
    got = keyswitch.keyswitch_mac(d, limbs)
    assert torch.equal(got, keyswitch.keyswitch_mac_plain(d, limbs))
    assert torch.equal(got[0], (d[0].to(torch.int64)[:, None] * k).sum(0))


@pytest.mark.parametrize("N", [8, 512, 2048, 32768, 65536])
def test_fft_forward_inverse(gen, N):
    x = torch.randint(-(1 << 21), 1 << 21, (5, N), generator=gen,
                      device="cuda").to(torch.float64)
    spec = fourstep_fft.fft_forward(x)
    assert close(spec, fourstep_fft.fft_forward_plain(x), 1e-12)
    back = fourstep_fft.fft_inverse(spec)
    assert close(back, fourstep_fft.fft_inverse_plain(spec), 1e-12)
    assert close(back, x, 1e-12)


BASE_LOG = {1: 22, 2: 14, 3: 10}


@pytest.mark.parametrize("level", [1, 2, 3])
@pytest.mark.parametrize("K", [1, 2, 3])
@pytest.mark.parametrize("N", [8, 512, 2048, 32768, 65536])
def test_cmux_step_entry_points(gen, N, K, level):
    """One CMux step through the three launches: the digit transforms of
    X^s * acc - acc, the MAC on the dig planes they write, the inverse
    rounded onto the torus and added to acc; each against its plain
    version on the same inputs."""
    B = 5
    acc = torus.random_torus(gen, (B, K, N), device="cuda")
    shifts = torch.randint(0, 2 * N, (B,), generator=gen, device="cuda")
    reset_launch_counts()
    dig = fourstep_fft.fft_forward_digits(acc, shifts, BASE_LOG[level], level)
    assert launch_counts()["fft_forward"] == 1
    assert dig.shape == (B, 2, K * level, N // 2) and dig.is_contiguous()
    assert close(dig, fourstep_fft.fft_forward_digits_plain(acc, shifts, BASE_LOG[level],
                                                            level), 1e-12)
    no_shift = fourstep_fft.fft_forward_digits(acc, None, BASE_LOG[level], level)
    assert close(no_shift, fourstep_fft.fft_forward_digits_plain(acc, None, BASE_LOG[level],
                                                                 level), 1e-12)
    bsk = torch.randn((2, K * level, K, N // 2), generator=gen, device="cuda",
                      dtype=torch.float64) * 2.0 ** 40
    out = external_product.external_product_mac(dig, bsk)
    assert close(out, external_product.external_product_mac_plain(dig, bsk), 1e-9)
    reset_launch_counts()
    got = fourstep_fft.fft_inverse_torus(out, acc)
    assert launch_counts()["fft_inverse"] == 1
    want = fourstep_fft.fft_inverse_torus_plain(out, acc)
    scale = fourstep_fft.fft_inverse_plain(
        out.transpose(1, 2).reshape(B * K, 2, N // 2)).abs().max().item()
    assert (got - want).abs().max().item() <= 1e-12 * scale + 1
    bare = fourstep_fft.fft_inverse_torus(out, None)
    assert (bare - fourstep_fft.fft_inverse_torus_plain(out, None)).abs().max().item() \
        <= 1e-12 * scale + 1


@pytest.mark.parametrize("v", [0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 2.0 ** 32 + 0.5,
                               -(2.0 ** 33) - 0.5, 2.0 ** 52 + 1, 2.0 ** 63,
                               -(2.0 ** 63), 2.0 ** 64 + 2.0 ** 40, 2.0 ** 94,
                               -(2.0 ** 94), 3.0 * 2.0 ** 92])
def test_fft_inverse_torus_rounds_exactly(gen, v):
    """A constant spectrum v at N = 8 inverts exactly to v at coefficient
    0: the kernel's rounding of exact halves and of values near 2^94 must
    equal `float_to_torus`'s bit for bit."""
    planes = torch.zeros((1, 2, 1, 4), dtype=torch.float64, device="cuda")
    planes[:, 0] = v
    want = torus.float_to_torus(torch.tensor([v] + [0.0] * 7, dtype=torch.float64,
                                             device="cuda"))
    assert torch.equal(fourstep_fft.fft_inverse_torus(planes, None)[0, 0], want)


@pytest.mark.parametrize("F", [1000, 999])
@pytest.mark.parametrize("B", ROWS)
@pytest.mark.parametrize("J,K", [(1, 1), (2, 1), (3, 1), (2, 2), (4, 2), (6, 2),
                                 (3, 3), (6, 3), (9, 3)])
def test_external_product_mac(gen, J, K, B, F):
    """Every (J, K) case the kernel builds, at every row count of the
    contract, with an even and an odd F."""
    dig = torch.randn((B, 2, J, F), generator=gen, device="cuda", dtype=torch.float64)
    bsk = torch.randn((2, J, K, F), generator=gen, device="cuda", dtype=torch.float64)
    got = external_product.external_product_mac(dig, bsk)
    assert close(got, external_product.external_product_mac_plain(dig, bsk), 1e-9)


def test_external_product_mac_refuses_unbuilt_shape(gen):
    dig = torch.zeros((1, 2, 5, 64), device="cuda", dtype=torch.float64)
    bsk = torch.zeros((2, 5, 2, 64), device="cuda", dtype=torch.float64)
    with pytest.raises(RuntimeError, match="external_product_mac launch failed"):
        external_product.external_product_mac(dig, bsk)


@pytest.mark.parametrize("p", [TEST_PARAMS, TEST_PARAMS_K2], ids=lambda p: p.name)
def test_fused_lut_batch_on_the_card(gen, p):
    ctx = TFHEContext.create(gen, p)
    msgs = torch.arange(6, device="cuda") % p.plaintext_modulus
    cts = ctx.encrypt(gen, msgs)
    table = [(v + 1) % p.plaintext_modulus for v in range(p.plaintext_modulus)]
    reset_launch_counts()
    out = TaurusEngine.from_context(ctx).lut_batch_tables(cts, table)
    assert launch_counts() == {"keyswitch_mac": 1, "fft_forward": p.n,
                               "fft_inverse": p.n, "external_product_mac": p.n}
    assert ctx.decrypt(out).tolist() == [table[m] for m in msgs.tolist()]
    ref = TaurusEngine.from_context(ctx, kernel_backend="reference").lut_batch_tables(
        cts, table)
    assert ctx.decrypt(ref).tolist() == ctx.decrypt(out).tolist()


@pytest.fixture(scope="module")
def int_ctx():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    gen = torch.Generator(device="cuda").manual_seed(11)
    return IntegerContext.create(TFHEContext.create(gen, TEST_PARAMS_4BIT)), gen


RADIX_CASES = [("add", "radix_add", 0xBE, 0x7C, (0xBE + 0x7C) % 256),
               ("mul", "radix_mul", 0xB7, 0x59, (0xB7 * 0x59) % 256),
               ("compare", "radix_cmp", 0x34, 0x9A, 1),
               ("relu_clamp", "radix_relu", -5, None, 0),
               ("relu_clamp", "radix_relu", 0x5A, None, 0x5A)]


@pytest.mark.parametrize("op,ir_op,a,b,want", RADIX_CASES)
def test_radix_integers_on_the_card(int_ctx, op, ir_op, a, b, want):
    """8-bit radix integers (4 two-bit digits) with the port's own keys on
    the card, through the fused engine: each op decrypts to the oracle,
    runs as many rounds as its plan, and every round launches the four
    kernels (1, n, n, n) times."""
    ic, gen = int_ctx
    assert ic.engine.kernel_backend == "fused" and ic.engine.device.type == "cuda"
    ca = ic.encrypt(gen, a, 8)
    cb = None if b is None else ic.encrypt(gen, b, 8)
    ic.reset_stats()
    reset_launch_counts()
    out = ic.relu_clamp(ca) if b is None else getattr(ic, op)(ca, cb)
    got = int(ic.ctx.decrypt(out)) if op == "compare" else ic.decrypt(out)
    assert got == want
    rounds = ic.stats["lut_batches"]
    spec = ic.spec(8)
    assert rounds == len(radix_round_plan(ir_op, spec.n_digits, spec.msg_bits))
    n = ic.params.n
    assert launch_counts() == {"keyswitch_mac": rounds, "fft_forward": rounds * n,
                               "fft_inverse": rounds * n,
                               "external_product_mac": rounds * n}
