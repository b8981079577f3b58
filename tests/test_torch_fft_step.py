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
import ast
import re
from pathlib import Path

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


# --- what the benchmark's kernel readers take from the FFT launches ------------

FFT_CU = Path(fourstep_fft.__file__).with_name("csrc") / "fft.cu"
KERNELS_READER = Path(__file__).resolve().parents[1] / "perfbench" / "metrics" / "kernels.py"


def reader_pattern():
    """The `FFT` pattern of `perfbench/metrics/kernels.py`, read from its
    source (the module imports the benchmark's package)."""
    for node in ast.parse(KERNELS_READER.read_text()).body:
        if isinstance(node, ast.Assign) and [getattr(t, "id", None)
                                             for t in node.targets] == ["FFT"]:
            return re.compile(node.value.args[0].value)
    raise AssertionError("no FFT pattern in perfbench/metrics/kernels.py")


def test_fft_kernel_keeps_its_template_signature():
    """The profiler names the kernel by its template arguments, which the
    readers parse: lg M, the mode, the complex type."""
    assert re.search(r"template <int LOG_M, int MODE, class V>\n__global__ void[^\n]*\n"
                     r"fft_kernel\(Args a\)", FFT_CU.read_text())


@pytest.mark.parametrize("mode", [1, 3])
def test_reader_pattern_names_the_n_65536_kernels(mode):
    name = (f"void (anonymous namespace)::fft_kernel<15, {mode}, double2>"
            f"((anonymous namespace)::Args)")
    m = reader_pattern().search(name)
    assert m is not None and m.groups() == ("15", str(mode))


def test_launches_put_their_rows_on_grid_y(monkeypatch):
    """The readers take a launch's rows from its grid y: B * K * level for
    the forward digits, B * K for the inverse torus, one cluster of
    blocks per row along x.  The wrappers pass B, K and level through."""
    text = FFT_CU.read_text()
    assert "cfg.gridDim = dim3(CF::P, rows, 1);" in text
    assert re.search(r"return dispatch<kFwdDigits>\(\s*N, B \* K \* level,", text)
    assert re.search(r"return dispatch<kInvTorus>\(\s*N, B \* K,", text)
    calls = []
    monkeypatch.setattr(fourstep_fft, "_check", lambda *a: None)
    monkeypatch.setattr(fourstep_fft._build, "function", lambda *a: "launcher")
    monkeypatch.setattr(fourstep_fft._build, "launch",
                        lambda kernel, fn, *args, device: calls.append((kernel, args)))
    src = torch.empty((5, 2, 65536), dtype=torch.int64, device="meta")
    fourstep_fft.fft_forward_digits(src, None, 11, 3)
    planes = torch.empty((5, 2, 2, 32768), dtype=torch.float64, device="meta")
    fourstep_fft.fft_inverse_torus(planes, None)
    assert calls == [("fft_forward", (0, None, 0, 5, 2, 65536, 11, 3)),
                     ("fft_inverse", (0, None, 0, 5, 2, 65536))]


def test_residency_needs_a_card(monkeypatch):
    """The residency is the card's occupancy: without CUDA it raises, for a
    size it has no kernel for too."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(ValueError, match="residency: needs a CUDA device"):
        fourstep_fft.residency(65536)
    with pytest.raises(ValueError, match="residency: needs N a power of two"):
        fourstep_fft.residency(3000)


# --- one CMux step against the exact product (kernels/cmux_accuracy.py) -------

def schoolbook_mac(digits, polys):
    """sum_j digits[b, j] * polys[j, k] mod (X^n + 1, 2^64), in Python ints."""
    Bs, J, n = digits.shape
    K = polys.shape[1]
    out = np.zeros((Bs, K, n), dtype=np.uint64)
    for b in range(Bs):
        for k in range(K):
            acc = [0] * n
            for j in range(J):
                d, w = digits[b, j].tolist(), polys[j, k].tolist()
                for s in range(n):
                    for t in range(n):
                        i, sign = (s + t, 1) if s + t < n else (s + t - n, -1)
                        acc[i] += sign * d[s] * w[t]
            out[b, k] = [v % 2 ** 64 for v in acc]
    return out


def test_exact_mac_matches_schoolbook():
    from repro_torch.kernels.cmux_accuracy import exact_mac
    rng = np.random.default_rng(7)
    n = 32
    digits = rng.integers(-(1 << 21), 1 << 21, (2, 3, n))
    polys = rng.integers(0, 2 ** 64, (3, 2, n), dtype=np.uint64)
    got = exact_mac(torch.as_tensor(digits), u64_to_tensor(polys, "cpu"))
    np.testing.assert_array_equal(tensor_to_u64(got), schoolbook_mac(digits, polys))


def test_step_errors_measure_the_float_rounding():
    """On CPU tensors both pipelines are the plain torch.fft one: their
    errors against the exact step are the f64 rounding, nonzero and far
    under the PBS noise (2^-30 of the torus at these sizes)."""
    from repro_torch.core.params import TEST_PARAMS_4BIT
    from repro_torch.kernels.cmux_accuracy import step_errors
    e = step_errors(TEST_PARAMS_4BIT, 2, torch.Generator().manual_seed(3))
    for name in ("kernels", "torch_fft"):
        assert 0 < e[name]["rms"] <= e[name]["max"] < 2.0 ** -30, (name, e[name])
