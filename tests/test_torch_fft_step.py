"""The CMux step's two fused transform entry points, on the CPU.

`fourstep_fft.fft_forward_digits` (rotate, subtract, decompose, forward
transform) and `fourstep_fft.fft_inverse_torus` (inverse transform,
`float_to_torus`, accumulator add) run one CUDA launch each on the card.
On the CPU they run their plain versions, which must compute bit for bit
what the separate ops computed before they were fused, and agree with the
JAX package: the digit spectra with `decompose` plus the Pallas
`fourstep_fft.fft_forward` (interpret mode, f64) to 1e-12 of the spectrum
scale, the torus rounding with `torus.float_to_torus` bit for bit.
`tests/test_torch_cuda.py` holds the kernels to these plain versions.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import batch as jbatch, decompose as jdec, torus as jtorus  # noqa: E402
from repro.kernels import fourstep_fft as jff  # noqa: E402
from repro_torch.core import batch, decompose as dec, torus  # noqa: E402
from repro_torch.interop import tensor_to_u64, u64_to_tensor  # noqa: E402
from repro_torch.kernels import fourstep_fft, launch_counts, reset_launch_counts  # noqa: E402

N = 64
B = 3
BASE_LOG = {1: 22, 2: 32, 3: 6}          # level 2 x 32 bits: no rounding shift
FIXED_SHIFTS = {"0": 0, "1": 1, "N-1": N - 1, "N": N, "N+1": N + 1, "2N-1": 2 * N - 1}
SHIFTS = [*FIXED_SHIFTS, "random", "none"]


@pytest.fixture(autouse=True)
def no_launches_on_cpu():
    reset_launch_counts()
    yield
    assert set(launch_counts().values()) == {0}


def make_src(K, seed):
    return np.random.default_rng(seed).integers(0, 2 ** 64, (B, K, N), dtype=np.uint64)


def make_shifts(kind, seed):
    if kind == "none":
        return None
    if kind == "random":
        return np.random.default_rng(seed).integers(0, 2 * N, B)
    return np.full(B, FIXED_SHIFTS[kind], dtype=np.int64)


def composed_forward(src, shifts, base_log, level):
    """The CMux step's prologue as separate ops, as `external_product_planes`
    and `blind_rotate_fused` ran it before the fusion."""
    Bs, K, n = src.shape
    v = src if shifts is None else batch.rotate_batch(src, shifts, n) - src
    digs = dec.decompose(v, base_log, level).movedim(-1, -2).reshape(Bs * K * level, n)
    spec = fourstep_fft.fft_forward(digs.to(torch.float64))
    return spec.reshape(Bs, K * level, 2, n // 2).transpose(1, 2).contiguous()


@pytest.mark.parametrize("shift", SHIFTS)
@pytest.mark.parametrize("level", [1, 2, 3])
@pytest.mark.parametrize("K", [1, 2, 3])
def test_forward_digits_bit_identical_to_the_composition(K, level, shift):
    src = u64_to_tensor(make_src(K, 10 * K + level), "cpu")
    s = make_shifts(shift, K + level)
    s = None if s is None else torch.as_tensor(s, dtype=torch.int64)
    got = fourstep_fft.fft_forward_digits(src, s, BASE_LOG[level], level)
    want = composed_forward(src, s, BASE_LOG[level], level)
    assert got.shape == (B, 2, K * level, N // 2) and got.dtype == torch.float64
    assert torch.equal(got, want)


@pytest.mark.parametrize("shift", ["random", "none"])
@pytest.mark.parametrize("level", [1, 2, 3])
@pytest.mark.parametrize("K", [1, 2, 3])
def test_forward_digits_matches_jax(K, level, shift):
    base_log = BASE_LOG[level]
    src = make_src(K, 100 + K * level)
    s = make_shifts(shift, 7 * K + level)
    v = jnp.asarray(src)
    if s is not None:
        v = jbatch.rotate_batch(v, jnp.asarray(s), N) - v
    digits = jnp.moveaxis(jdec.decompose(v, base_log, level), -1, -2)
    spec = jff.fft_forward(digits.reshape(B * K * level, N).astype(jnp.float64),
                           dtype=jnp.float64)
    want = np.asarray(spec).reshape(B, K * level, 2, N // 2).transpose(0, 2, 1, 3)
    got = fourstep_fft.fft_forward_digits(
        u64_to_tensor(src, "cpu"), None if s is None else torch.as_tensor(s),
        base_log, level).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12 * np.abs(want).max())


def random_planes(K, seed, scale):
    rng = np.random.default_rng(seed)
    return torch.as_tensor(rng.standard_normal((B, 2, K, N // 2)) * scale)


@pytest.mark.parametrize("with_acc", [False, True])
@pytest.mark.parametrize("K", [1, 2, 3])
def test_inverse_torus_bit_identical_to_the_composition(K, with_acc):
    planes = random_planes(K, K, 2.0 ** 80)
    acc = u64_to_tensor(make_src(K, 50 + K), "cpu") if with_acc else None
    got = fourstep_fft.fft_inverse_torus(planes, acc)
    coeffs = fourstep_fft.fft_inverse(planes.transpose(1, 2).reshape(B * K, 2, N // 2))
    want = torus.float_to_torus(coeffs).reshape(B, K, N)
    if with_acc:
        want = acc + want
    assert got.dtype == torch.int64 and torch.equal(got, want)


@pytest.mark.parametrize("scale", [1.0, 2.0 ** 40, 2.0 ** 88])
def test_inverse_torus_rounds_like_jax(scale):
    """The torus rounding of the inverse floats, held to JAX's
    `float_to_torus` on the same floats; the spectrum is scaled so that
    the coefficients reach the 2^94 end of `float_to_torus`'s range."""
    K = 2
    planes = random_planes(K, 9, scale)
    acc = make_src(K, 77)
    coeffs = fourstep_fft.fft_inverse(planes.transpose(1, 2).reshape(B * K, 2, N // 2))
    want = np.asarray(jtorus.float_to_torus(jnp.asarray(coeffs.numpy()))).reshape(B, K, N)
    got = tensor_to_u64(fourstep_fft.fft_inverse_torus(planes, u64_to_tensor(acc, "cpu")))
    assert np.array_equal(got, want + acc)


SPECIAL = [0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 2.0 ** 32 + 0.5, -(2.0 ** 33) - 0.5,
           2.0 ** 52 + 1, 2.0 ** 63, -(2.0 ** 63), 2.0 ** 64 + 2.0 ** 40,
           2.0 ** 94, -(2.0 ** 94), 3.0 * 2.0 ** 92]


@pytest.mark.parametrize("v", SPECIAL)
def test_inverse_torus_special_values_match_jax(v):
    """A constant spectrum v at N = 8 inverts exactly to v at coefficient 0
    and 0 elsewhere, so the rounding of exact halves and of values near
    2^94 reaches `fft_inverse_torus` unchanged."""
    planes = torch.zeros((1, 2, 1, 4), dtype=torch.float64)
    planes[:, 0] = v
    coeffs = fourstep_fft.fft_inverse(planes.reshape(1, 2, 4))
    assert coeffs[0, 0].item() == v and not coeffs[0, 1:].any()
    want = np.asarray(jtorus.float_to_torus(jnp.asarray(coeffs.numpy()))).reshape(1, 1, 8)
    assert np.array_equal(tensor_to_u64(fourstep_fft.fft_inverse_torus(planes, None)), want)


def test_entry_points_refuse_meta_tensors():
    src = torch.empty((2, 2, 64), dtype=torch.int64, device="meta")
    with pytest.raises(ValueError, match="fft_forward_digits"):
        fourstep_fft.fft_forward_digits(src, None, 22, 1)
    planes = torch.empty((2, 2, 2, 32), dtype=torch.float64, device="meta")
    with pytest.raises(ValueError, match="fft_inverse_torus"):
        fourstep_fft.fft_inverse_torus(planes, None)
