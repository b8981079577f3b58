"""The port's CUDA kernels against their plain PyTorch versions, on a card.

These tests need a CUDA device and skip without one.  The machine with
the card has no JAX, and `tests/conftest.py` imports it, so run them
there without the conftest:

    python -m pytest -q --noconftest tests/test_torch_cuda.py

Tolerances are the contract's: the keyswitch MAC bit-exact, the FFTs
within 1e-12 of the output scale, the MAC within 1e-9 relative.
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.engine import TaurusEngine  # noqa: E402
from repro_torch.core.params import TEST_PARAMS, TEST_PARAMS_K2  # noqa: E402
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
