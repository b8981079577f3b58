"""`repro_torch.kernels.ops` against `repro.kernels.ops`, whose Pallas
kernels run in interpret mode as the JAX package's own tests run them.

The shapes and tolerances are the reference tests' (tests/test_kernels.py,
tests/test_kernel_sweeps.py): the f32 FFTs within 2e-5 of the spectrum
scale of an f64 oracle, the f32 MAC within 1e-2 absolute (1e-4
relative), and the keyswitch exact mod 2^64 over the whole int32 digit
range.  On the CPU each wrapper takes its plain PyTorch version (complex64
`torch.fft` and `einsum` for f32); `tests/test_torch_cuda.py` holds the
CUDA kernels to the same plain versions on the card.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import external_product as jep, fourstep_fft as jff  # noqa: E402
from repro.kernels import ops as jops, ref  # noqa: E402
from repro_torch.interop import tensor_to_u64, u64_to_tensor  # noqa: E402
from repro_torch.kernels import external_product, fourstep_fft, keyswitch, ops  # noqa: E402
from repro_torch.kernels import launch_counts, reset_launch_counts  # noqa: E402

jax.config.update("jax_enable_x64", True)


@pytest.fixture(autouse=True)
def no_launches_on_cpu():
    """Every test here runs on the CPU: no kernel may count a launch."""
    reset_launch_counts()
    yield
    assert set(launch_counts().values()) == {0}


def t(a, dtype=None):
    return torch.as_tensor(np.asarray(a), dtype=dtype)


# --- four-step FFT ------------------------------------------------------------

@pytest.mark.parametrize("N", [256, 512, 2048, 8192, 65536])
@pytest.mark.parametrize("B", [1, 3])
def test_negacyclic_fft_matches_reference(N, B):
    rng = np.random.default_rng(N + B)
    x = rng.integers(-(1 << 7), 1 << 7, (B, N)).astype(np.float32)
    got = ops.negacyclic_fft(t(x))
    assert got.dtype == torch.float32 and tuple(got.shape) == (B, 2, N // 2)
    want = np.asarray(ref.fft_forward_ref(jnp.asarray(x)))
    jgot = np.asarray(jops.negacyclic_fft(jnp.asarray(x)))
    scale = np.max(np.abs(want)) + 1.0
    np.testing.assert_allclose(got.numpy() / scale, want / scale, atol=2e-5)
    np.testing.assert_allclose(got.numpy() / scale, jgot / scale, atol=4e-5)


@pytest.mark.parametrize("N", [256, 2048, 65536])
def test_negacyclic_fft_roundtrip(N):
    rng = np.random.default_rng(N)
    x = rng.integers(-(1 << 10), 1 << 10, (2, N)).astype(np.float32)
    back = ops.negacyclic_ifft(ops.negacyclic_fft(t(x)))
    jback = np.asarray(jops.negacyclic_ifft(jops.negacyclic_fft(jnp.asarray(x))))
    assert back.dtype == torch.float32
    atol = 0.25 * np.sqrt(N) / 8
    np.testing.assert_allclose(back.numpy(), x, atol=atol)
    np.testing.assert_allclose(back.numpy(), jback, atol=2 * atol)


@pytest.mark.parametrize("N", [512, 2048])
def test_negacyclic_convolution_property(N):
    """A pointwise product of two f32 spectra inverts to the exact
    negacyclic convolution, as in the reference's test."""
    rng = np.random.default_rng(N + 7)
    a = rng.integers(-64, 64, N)
    b = rng.integers(-64, 64, N)
    sa = ops.negacyclic_fft(t(a[None], torch.float32))
    sb = ops.negacyclic_fft(t(b[None], torch.float32))
    pr = sa[:, 0] * sb[:, 0] - sa[:, 1] * sb[:, 1]
    pi = sa[:, 0] * sb[:, 1] + sa[:, 1] * sb[:, 0]
    got = ops.negacyclic_ifft(torch.stack([pr, pi], dim=1))[0].numpy()
    want = np.zeros(N, dtype=np.int64)
    for i in range(N):
        k = (i + np.arange(N)) % (2 * N)
        np.add.at(want, k % N, np.where(k < N, a[i] * b, -(a[i] * b)))
    np.testing.assert_allclose(got, want, atol=np.maximum(1.0, np.abs(want).max() * 3e-5))


@pytest.mark.parametrize("dtype,rtol", [("float32", 2e-5), ("float64", 1e-12)])
@pytest.mark.parametrize("N", [256, 2048, 8192])
def test_fft_dtype_sweep(N, dtype, rtol):
    """`fft_forward` / `fft_inverse` with `dtype=` give that plane type, to
    the reference's gates against its f64 oracle and the reference kernel."""
    rng = np.random.default_rng(N)
    x = rng.integers(-2 ** 20, 2 ** 20, (2, N)).astype(np.float64)
    tdt = getattr(torch, dtype)
    spec = fourstep_fft.fft_forward(t(x, tdt), tdt)
    assert spec.dtype == tdt
    ref_spec = np.asarray(ref.fft_forward_ref(jnp.asarray(x)))
    jspec = np.asarray(jff.fft_forward(jnp.asarray(x, dtype), dtype=getattr(jnp, dtype)))
    scale = np.abs(ref_spec).max()
    np.testing.assert_allclose(spec.numpy(), ref_spec, atol=scale * rtol, rtol=0)
    np.testing.assert_allclose(spec.numpy(), jspec, atol=2 * scale * rtol, rtol=0)
    back = fourstep_fft.fft_inverse(spec, tdt)
    assert back.dtype == tdt
    np.testing.assert_allclose(back.numpy(), x, atol=scale * rtol)


# --- BRU external-product MAC ---------------------------------------------------

@pytest.mark.parametrize("B,J,K,F", [(1, 2, 2, 256), (12, 4, 2, 1024),
                                     (12, 6, 3, 2048), (48, 4, 2, 16384)])
def test_bru_mac_matches_reference(B, J, K, F):
    rng = np.random.default_rng(B * F)
    dig = (rng.standard_normal((B, 2, J, F)) * 100).astype(np.float32)
    bsk = rng.standard_normal((2, J, K, F)).astype(np.float32)
    got = ops.bru_mac(t(dig), t(bsk))
    assert got.dtype == torch.float32
    want = np.asarray(ref.external_product_mac_ref(jnp.asarray(dig), jnp.asarray(bsk)))
    jgot = np.asarray(jops.bru_mac(jnp.asarray(dig), jnp.asarray(bsk)))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-2)
    np.testing.assert_allclose(got.numpy(), jgot, rtol=2e-4, atol=2e-2)


@pytest.mark.parametrize("block_f", [128, 512, 2048])
def test_bru_mac_block_sweep(block_f):
    rng = np.random.default_rng(block_f)
    dig = rng.standard_normal((4, 2, 4, 2048)).astype(np.float32)
    bsk = rng.standard_normal((2, 4, 2, 2048)).astype(np.float32)
    got = ops.bru_mac(t(dig), t(bsk), block_f=block_f)
    want = np.asarray(ref.external_product_mac_ref(jnp.asarray(dig), jnp.asarray(bsk)))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-2), ("float64", 1e-9)])
@pytest.mark.parametrize("B", [1, 12])
def test_external_product_mac_dtype_sweep(B, dtype, tol):
    rng = np.random.default_rng(B)
    dig = rng.normal(size=(B, 2, 4, 512)) * 100
    bsk = rng.normal(size=(2, 4, 2, 512))
    tdt = getattr(torch, dtype)
    got = external_product.external_product_mac(t(dig, tdt), t(bsk, tdt), tdt)
    assert got.dtype == tdt
    want = np.asarray(ref.external_product_mac_ref(jnp.asarray(dig), jnp.asarray(bsk)))
    jgot = np.asarray(jep.external_product_mac(jnp.asarray(dig, dtype), jnp.asarray(bsk, dtype),
                                               block_f=256, dtype=getattr(jnp, dtype)))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=tol)
    np.testing.assert_allclose(got.numpy(), jgot, rtol=0, atol=2 * tol)


@pytest.mark.parametrize("F,block_f", [(300, 256), (2048, 384)])
def test_bru_mac_refuses_what_the_reference_refuses(F, block_f):
    dig = np.zeros((1, 2, 4, F), np.float32)
    bsk = np.zeros((2, 4, 2, F), np.float32)
    with pytest.raises(AssertionError):
        jops.bru_mac(jnp.asarray(dig), jnp.asarray(bsk), block_f=block_f)
    with pytest.raises(ValueError, match="bru_mac"):
        ops.bru_mac(t(dig), t(bsk), block_f=block_f)


def test_plane_types_other_than_f32_and_f64_raise():
    x = torch.zeros(1, 16, dtype=torch.float16)
    for run in (lambda: ops.negacyclic_fft(x, dtype=torch.float16),
                lambda: ops.negacyclic_ifft(torch.zeros(1, 2, 8), dtype=torch.bfloat16),
                lambda: ops.bru_mac(torch.zeros(1, 2, 2, 8), torch.zeros(2, 2, 2, 8),
                                    dtype=torch.float16)):
        with pytest.raises(ValueError, match="float64 or float32"):
            run()


# --- LPU key-switch MAC (int32 digits, exact mod 2^64) ---------------------------

def check_keyswitch(digits, ksk, block_s):
    want = np.asarray(ref.keyswitch_mac_ref(jnp.asarray(digits), jnp.asarray(ksk)))
    jgot = np.asarray(jops.lpu_keyswitch_mac(jnp.asarray(digits), jnp.asarray(ksk),
                                             block_s=block_s))
    got = tensor_to_u64(ops.lpu_keyswitch_mac(t(digits), u64_to_tensor(ksk, "cpu"),
                                              block_s=block_s))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, jgot)


@pytest.mark.parametrize("B,S,T", [(1, 128, 65), (4, 1024, 513), (2, 4096, 257)])
def test_lpu_keyswitch_mac_exact(B, S, T):
    rng = np.random.default_rng(S + T)
    digits = rng.integers(-(1 << 15), 1 << 15, (B, S)).astype(np.int32)
    ksk = rng.integers(0, 1 << 64, (S, T), dtype=np.uint64)
    check_keyswitch(digits, ksk, 1024)


@pytest.mark.parametrize("rows", [
    [-(1 << 31), (1 << 31) - 1, -1, 1, 0, 7, -7, 12345],
    [(1 << 31) - 1, (1 << 31) - 1, 2139062143, 2139062144, -2139062144, -2139062145,
     -(1 << 31), -(1 << 31)],
])
def test_lpu_keyswitch_mac_extreme_digits(rows):
    """The whole int32 range, past 2,139,062,143 (four base-2^8 digits'
    reach), stays exact."""
    digits = np.asarray([rows], dtype=np.int32)
    rng = np.random.default_rng(0)
    ksk = rng.integers(0, 1 << 64, (8, 33), dtype=np.uint64)
    check_keyswitch(digits, ksk, 8)


@pytest.mark.parametrize("block_s", [256, 512, 2048])
def test_lpu_keyswitch_mac_block_sweep(block_s):
    rng = np.random.default_rng(3)
    digits = rng.integers(-(1 << 31), (1 << 31) - 1, (3, 2048)).astype(np.int32)
    ksk = rng.integers(0, 1 << 64, (2048, 129), dtype=np.uint64)
    check_keyswitch(digits, ksk, block_s)


@pytest.mark.parametrize("S,block_s", [(100, 64), (2560, 1024), (33, 32)])
def test_lpu_keyswitch_mac_unaligned_block_padding(S, block_s):
    rng = np.random.default_rng(S)
    digits = rng.integers(-(1 << 12), 1 << 12, (2, S)).astype(np.int32)
    ksk = rng.integers(0, 1 << 64, (S, 65), dtype=np.uint64)
    check_keyswitch(digits, ksk, block_s)


def test_lpu_keyswitch_mac_refuses_blocks_past_4096():
    digits = np.zeros((1, 8192), np.int32)
    ksk = np.zeros((8192, 3), np.uint64)
    with pytest.raises(AssertionError):
        jops.lpu_keyswitch_mac(jnp.asarray(digits), jnp.asarray(ksk), block_s=8192)
    with pytest.raises(ValueError, match="lpu_keyswitch_mac"):
        ops.lpu_keyswitch_mac(t(digits), u64_to_tensor(ksk, "cpu"), block_s=8192)


def test_int32_split_is_exact_and_int8():
    d = torch.tensor([[-(1 << 31), (1 << 31) - 1, -1, 0, 2139062144, -2139062145],
                      [2139062143, -2139062144, 255, -256, 128, -129]], dtype=torch.int32)
    parts = keyswitch.split_int32(d)
    assert parts.dtype == torch.int8 and parts.shape == (5 * d.shape[0], d.shape[1])
    B = d.shape[0]
    back = sum(parts[i * B:(i + 1) * B].long() << (8 * i) for i in range(5))
    assert torch.equal(back, d.long())
    assert torch.equal(keyswitch.fold_int32(parts.long()), d.long())
