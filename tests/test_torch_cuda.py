"""The port's CUDA kernels against their plain PyTorch versions, on a card.

These tests need a CUDA device and skip without one.  The machine with
the card has no JAX, and `tests/conftest.py` imports it, so run them
there without the conftest:

    python -m pytest -q --noconftest tests/test_torch_cuda.py

Tolerances are the contract's: the keyswitch MAC bit-exact, the FFTs
within 1e-12 of the output scale, the MAC within 1e-9 relative, and the
torus output of `fft_inverse_torus` within 1e-12 of the float inverse's
scale plus one (the f64 transform's rounding, then one torus unit).
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.engine import TaurusEngine  # noqa: E402
from repro_torch.core.params import TEST_PARAMS, TEST_PARAMS_K2  # noqa: E402
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


@pytest.mark.parametrize("B,S,T", [(1, 64, 33), (12, 5000, 1004), (17, 1023, 129),
                                   (40, 300, 7)])
def test_keyswitch_mac_bit_exact(gen, B, S, T):
    d = torch.randint(-(1 << 31), (1 << 31) - 1, (B, S), generator=gen, device="cuda",
                      dtype=torch.int64).to(torch.int32)
    k = torch.randint(-(1 << 62), 1 << 62, (S, T), generator=gen, device="cuda") * 3
    reset_launch_counts()
    got = keyswitch.keyswitch_mac(d, k)
    assert launch_counts()["keyswitch_mac"] == 1
    assert torch.equal(got, keyswitch.keyswitch_mac_plain(d, k))


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


@pytest.mark.parametrize("J,K", [(1, 1), (2, 1), (3, 1), (2, 2), (4, 2), (6, 2),
                                 (3, 3), (6, 3), (9, 3)])
def test_external_product_mac(gen, J, K):
    F = 1000
    dig = torch.randn((12, 2, J, F), generator=gen, device="cuda", dtype=torch.float64)
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
