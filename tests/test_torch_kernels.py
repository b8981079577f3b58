"""The port's kernel modules (`repro_torch.kernels`) against the Pallas
kernels, which run in interpret mode as the JAX package's own tests run
them.  On the CPU each wrapper takes its plain PyTorch version, so these
tests hold the plain versions (the CUDA kernels' oracles on the card) to
the TPU kernels: the keyswitch MAC exactly, the f64 FFT to 1e-12 of the
spectrum scale, the MAC to 1e-9.  `tests/test_torch_cuda.py` holds the
CUDA kernels to the same plain versions on the card.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import external_product as jep, fourstep_fft as jff  # noqa: E402
from repro.kernels import fused_pbs as jfused, ops, ref  # noqa: E402
from repro_torch.interop import context_from_numpy, tensor_to_u64, u64_to_tensor  # noqa: E402
from repro_torch.kernels import external_product, fourstep_fft, fused_pbs, keyswitch  # noqa: E402
from repro_torch.kernels import fft_sweep, mac_sweep  # noqa: E402
from repro_torch.kernels import launch_counts, reset_launch_counts  # noqa: E402


@pytest.fixture(autouse=True)
def no_launches_on_cpu():
    """Every test here runs on the CPU: no kernel may count a launch."""
    reset_launch_counts()
    yield
    assert set(launch_counts().values()) == {0}


@pytest.fixture(scope="module")
def tctx_2bit(ctx_2bit):
    arrays = {k: np.asarray(getattr(ctx_2bit, k))
              for k in ("lwe_sk", "glwe_sk", "big_sk", "ksk", "bsk_f")}
    return context_from_numpy(dataclasses.asdict(ctx_2bit.params), arrays, "cpu")


def jax_keyswitch(digits, ksk_u64, block_s):
    return np.asarray(ops.lpu_keyswitch_mac(jnp.asarray(digits, dtype=jnp.int32),
                                            jnp.asarray(ksk_u64), block_s=block_s))


def port_keyswitch(digits, ksk_u64):
    """The port's MAC on int8 digits against the limb operand of the key."""
    limbs = keyswitch.ksk_limbs(u64_to_tensor(ksk_u64, "cpu"))
    return tensor_to_u64(keyswitch.keyswitch_mac(torch.as_tensor(digits, dtype=torch.int8),
                                                 limbs))


# --- keyswitch MAC ------------------------------------------------------------

@pytest.mark.parametrize("B,S,T,block_s", [(1, 128, 65, 128), (4, 1024, 513, 1024),
                                           (3, 2048, 129, 512)])
def test_keyswitch_mac_exact(B, S, T, block_s):
    rng = np.random.default_rng(S + T)
    digits = rng.integers(-128, 128, (B, S)).astype(np.int8)
    ksk = rng.integers(0, 2 ** 64, (S, T), dtype=np.uint64)
    got = port_keyswitch(digits, ksk)
    assert np.array_equal(got, jax_keyswitch(digits, ksk, block_s))
    assert np.array_equal(got, np.asarray(ref.keyswitch_mac_ref(
        jnp.asarray(digits, dtype=jnp.int32), jnp.asarray(ksk))))


@pytest.mark.parametrize("base_log", [3, 6, 8])
def test_keyswitch_mac_extreme_digits(base_log):
    """The extreme digits -2^(b-1) and 2^(b-1) - 1 against all-ones,
    high-bit-only and random KSK words."""
    lo, hi = -(1 << (base_log - 1)), (1 << (base_log - 1)) - 1
    digits = np.array([[lo, hi, -1, 1, 0, lo, hi, lo], [hi] * 8, [lo] * 8], dtype=np.int8)
    words = np.random.default_rng(base_log).integers(0, 2 ** 64, (8, 33), dtype=np.uint64)
    words[:, 0] = np.uint64(2 ** 64 - 1)
    words[:, 1] = np.uint64(1 << 63)
    words[::2, 2] = np.uint64(0x8080808080808080)
    assert np.array_equal(port_keyswitch(digits, words), jax_keyswitch(digits, words, 8))


@pytest.mark.parametrize("S,block_s", [(100, 64), (33, 32), (2560, 1024)])
def test_keyswitch_mac_unaligned_s(S, block_s):
    rng = np.random.default_rng(S)
    digits = rng.integers(-128, 128, (2, S)).astype(np.int8)
    ksk = rng.integers(0, 2 ** 64, (S, 65), dtype=np.uint64)
    assert np.array_equal(port_keyswitch(digits, ksk), jax_keyswitch(digits, ksk, block_s))


@pytest.mark.parametrize("digit", [-128, 127])
def test_keyswitch_mac_across_stretches(digit):
    """S beyond one exact int32 stretch (65,536 rows) with the largest
    limb sums there are: every digit extreme, every KSK word all ones
    or high-bit only.  One stretch's limb sum reaches -128 x 255 x 65,536,
    just inside int32; the fold must carry it into the uint64 result."""
    S, T = keyswitch.STRETCH + 1000, 3
    digits = np.full((2, S), digit, dtype=np.int8)
    digits[1, ::3] = 0
    ksk = np.full((S, T), 2 ** 64 - 1, dtype=np.uint64)
    ksk[:, 1] = np.uint64(1 << 63)
    ksk[::7, 2] = np.uint64(0xFF00FF00FF00FF00)
    want = np.asarray(ref.keyswitch_mac_ref(jnp.asarray(digits, dtype=jnp.int32),
                                            jnp.asarray(ksk)))
    assert np.array_equal(port_keyswitch(digits, ksk), want)


@pytest.mark.parametrize("S,T", [(2560, 65), (100, 7), (33, 1)])
def test_ksk_limbs_layout(S, T):
    """Row 8t + l of the limb operand is little-endian byte l of KSK column
    t; S is zero-padded to a multiple of 16."""
    ksk = np.random.default_rng(S * T).integers(0, 2 ** 64, (S, T), dtype=np.uint64)
    limbs = keyswitch.ksk_limbs(u64_to_tensor(ksk, "cpu"))
    S16 = -(-S // keyswitch.TILE_S) * keyswitch.TILE_S
    assert limbs.dtype == torch.uint8 and limbs.is_contiguous()
    assert limbs.shape == (8 * T, S16)
    got = limbs.numpy()
    for l in range(8):
        assert np.array_equal(got[l::8, :S], ((ksk >> np.uint64(8 * l)) & np.uint64(255)).T)
    assert not got[:, S:].any()


# --- four-step FFT ------------------------------------------------------------

@pytest.mark.parametrize("M", [4, 128, 1024, 16384, 32768])
def test_factor_m_matches(M):
    assert fourstep_fft.factor_m(M) == jff.factor_m(M)


@pytest.mark.parametrize("N", [256, 2048, 8192])
@pytest.mark.parametrize("B", [1, 3])
def test_fft_forward_inverse_f64(N, B):
    rng = np.random.default_rng(N + B)
    x = rng.integers(-2 ** 20, 2 ** 20, (B, N)).astype(np.float64)
    want = np.asarray(jff.fft_forward(jnp.asarray(x), dtype=jnp.float64))
    got = fourstep_fft.fft_forward(torch.as_tensor(x)).numpy()
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12 * scale)
    back = fourstep_fft.fft_inverse(torch.as_tensor(got)).numpy()
    np.testing.assert_allclose(back, x, rtol=0, atol=1e-12 * scale)
    jback = np.asarray(jff.fft_inverse(jnp.asarray(want), dtype=jnp.float64))
    np.testing.assert_allclose(back, jback, rtol=0, atol=1e-12 * scale)


@pytest.mark.parametrize("N", [512, 2048])
def test_fft_negacyclic_convolution_property(N):
    rng = np.random.default_rng(N + 7)
    a, b = rng.integers(-64, 64, N), rng.integers(-64, 64, N)
    sa = fourstep_fft.fft_forward(torch.as_tensor(a[None], dtype=torch.float64))
    sb = fourstep_fft.fft_forward(torch.as_tensor(b[None], dtype=torch.float64))
    prod = torch.stack([sa[:, 0] * sb[:, 0] - sa[:, 1] * sb[:, 1],
                        sa[:, 0] * sb[:, 1] + sa[:, 1] * sb[:, 0]], dim=1)
    got = fourstep_fft.fft_inverse(prod).numpy()[0]
    want = np.zeros(N, dtype=np.int64)
    for i in range(N):
        k = (i + np.arange(N)) % (2 * N)
        np.add.at(want, k % N, np.where(k < N, a[i] * b, -(a[i] * b)))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


# --- external-product MAC -----------------------------------------------------

@pytest.mark.parametrize("J,K,F", [(2, 2, 256), (4, 2, 512), (6, 3, 256)])
@pytest.mark.parametrize("B", [1, 12])
def test_external_product_mac_f64(B, J, K, F):
    rng = np.random.default_rng(J * K + F + B)
    dig = rng.normal(size=(B, 2, J, F)) * 100
    bsk = rng.normal(size=(2, J, K, F))
    want = np.asarray(jep.external_product_mac(jnp.asarray(dig), jnp.asarray(bsk),
                                               block_f=min(256, F), dtype=jnp.float64))
    got = external_product.external_product_mac(torch.as_tensor(dig), torch.as_tensor(bsk))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-9)


@pytest.mark.parametrize("digits,limbs", [
    (torch.full((2, 16), 200, dtype=torch.int32), torch.zeros((40, 16), dtype=torch.uint8)),
    (torch.zeros((2, 16), dtype=torch.int8), torch.zeros((5, 16), dtype=torch.int64)),
    (torch.zeros((2, 17), dtype=torch.int8), torch.zeros((40, 17), dtype=torch.uint8)),
], ids=["int32_digits", "int64_key", "unpadded_S"])
def test_keyswitch_mac_refuses_other_operands_on_cpu(digits, limbs):
    """The operand contract holds on the CPU as on the card: the plain
    version's limb sums are exact only for int8 digits and the limb
    operand of `ksk_limbs`."""
    with pytest.raises(ValueError, match="keyswitch_mac"):
        keyswitch.keyswitch_mac(digits, limbs)
    with pytest.raises(ValueError, match="keyswitch_mac"):
        keyswitch.keyswitch_mac_plain(digits, limbs)


@pytest.mark.parametrize("threads,rows", mac_sweep.VARIANTS)
def test_mac_sweep_variants_rewrite_the_kernel_source(threads, rows):
    """Each block shape the sweep builds on the card rewrites exactly the
    shipped kernel's two constants and keeps only the gpt2 (J, K) case."""
    src = mac_sweep.SRC.read_text()
    text = mac_sweep.variant_source(src, threads, rows)
    assert f"constexpr int kThreads = {threads};" in text
    assert f"constexpr int kRows = {rows};" in text
    assert "EP_CASE(2, 2)" in text and "EP_CASE(9, 3)" not in text
    assert text.count("\n") < src.count("\n")


@pytest.mark.parametrize("shape,name", [(s, n) for s, vs in fft_sweep.VARIANTS.items()
                                        for n in vs])
def test_fft_sweep_variants_rewrite_the_kernel_source(shape, name):
    """Each FFT plan the sweep builds on the card sets the shipped kernel's
    radix, cluster size, threads and buffer sharing, and instantiates only
    its shape's lg M; the phase probe marks all ten boundaries."""
    radix, p, vpt, share, probe = fft_sweep.VARIANTS[shape][name]
    lg = fft_sweep.log_m(shape)
    src = fft_sweep.SRC.read_text()
    text = fft_sweep.variant_source(src, lg, radix, p, vpt, share, probe)
    assert f"constexpr int kMaxRadix = {radix};" in text
    assert f"static constexpr int P = LOG_M >= 12 ? {p} : 1;" in text
    assert f"static constexpr bool SHARE = {str(share).lower()};" in text
    assert f"FFT_CASE({lg})" in text and "FFT_CASE(2)" not in text
    assert text.count("  mark(") == (10 if probe == "phases" else 0)


# --- wrappers raise on devices they have no kernel for -------------------------

def test_wrappers_refuse_non_cuda_non_cpu_tensors():
    meta = lambda *s, dt=torch.float64: torch.empty(*s, dtype=dt, device="meta")
    with pytest.raises(ValueError, match="keyswitch_mac"):
        keyswitch.keyswitch_mac(meta(2, 16, dt=torch.int8), meta(40, 16, dt=torch.uint8))
    with pytest.raises(ValueError, match="fft_forward"):
        fourstep_fft.fft_forward(meta(2, 64))
    with pytest.raises(ValueError, match="fft_inverse"):
        fourstep_fft.fft_inverse(meta(2, 2, 32))
    with pytest.raises(ValueError, match="external_product_mac"):
        external_product.external_product_mac(meta(1, 2, 2, 8), meta(2, 2, 2, 8))


# --- launches past the grid's 65,535 rows ---------------------------------------

@pytest.mark.parametrize("B,per,want", [
    (16400, 4, [(0, 16383), (16383, 16400)]),    # TEST_PARAMS digits: B K level = 65,600
    (16400, 2, [(0, 16400)]),                     # its torus rows: B K = 32,800
    (65535, 1, [(0, 65535)]),
    (65536, 1, [(0, 65535), (65535, 65536)]),
    (0, 3, []),
])
def test_row_slices_plan(B, per, want):
    plan = fourstep_fft.row_slices(B, per)
    assert plan == want
    assert all((b1 - b0) * per <= fourstep_fft.MAX_GRID_Y for b0, b1 in plan)
    with pytest.raises(ValueError, match="rows per item"):
        fourstep_fft.row_slices(4, 70000)


def test_mac_row_limit_matches_its_kernel():
    src = (external_product.__file__.rsplit("/", 1)[0] + "/csrc/external_product.cu")
    text = open(src).read()
    assert f"constexpr int kRows = {external_product.ROWS_PER_BLOCK};" in text
    assert external_product.MAX_ROWS == 131070
    assert fourstep_fft.row_slices(131071, 1, external_product.MAX_ROWS) == \
        [(0, 131070), (131070, 131071)]


def test_wrappers_launch_once_per_slice(monkeypatch):
    """Each wrapper's launches, with the kernel call recorded instead of
    made: one per slice, each given its slice's rows and pointers offset
    by the slice's start (meta tensors: data_ptr is the byte offset)."""
    from repro_torch.kernels import _build
    calls = []
    monkeypatch.setattr(_build, "function", lambda lib, name, n_ptr, n_int: name)
    monkeypatch.setattr(_build, "launch",
                        lambda kernel, fn, *args, device: calls.append((fn, args)))
    monkeypatch.setattr(fourstep_fft, "_check", lambda *a: None)
    monkeypatch.setattr(fourstep_fft, "_check_aux", lambda *a: None)
    monkeypatch.setattr(_build, "require", lambda *a: None)
    meta = lambda *s, dt=torch.float64: torch.empty(*s, dtype=dt, device="meta")
    B, K, lvl, N = 16400, 2, 2, 16
    fourstep_fft.fft_forward_digits(meta(B, K, N, dt=torch.int64), meta(B, dt=torch.int64),
                                    12, lvl)
    assert [(a[3], a[0], a[1], a[2]) for _, a in calls] == [
        (16383, 0, 0, 0), (17, 16383 * K * N * 8, 16383 * 8, 16383 * 2 * K * lvl * N // 2 * 8)]
    calls.clear()
    fourstep_fft.fft_inverse_torus(meta(70000, 2, 1, N // 2), meta(70000, 1, N, dt=torch.int64))
    assert [a[3] for _, a in calls] == [65535, 4465]
    assert calls[1][1][:3] == (65535 * 2 * N // 2 * 8, 65535 * N * 8, 65535 * N * 8)
    calls.clear()
    fourstep_fft.fft_forward(meta(65536, N))
    fourstep_fft.fft_inverse(meta(65536, 2, N // 2))
    assert [(fn, a[2]) for fn, a in calls] == [
        ("fft_forward_launch", 65535), ("fft_forward_launch", 1),
        ("fft_inverse_launch", 65535), ("fft_inverse_launch", 1)]
    calls.clear()
    fourstep_fft.fft_forward_digits(meta(12, K, N, dt=torch.int64), None, 12, lvl)
    external_product.external_product_mac(meta(12, 2, 2, 8), meta(2, 2, 2, 8))
    assert [a[3] for _, a in calls] == [12, 12]              # a call that fits: one launch
    calls.clear()
    external_product.external_product_mac(meta(131071, 2, 2, 8), meta(2, 2, 2, 8))
    assert [(a[3], a[1]) for _, a in calls] == [(131070, 0), (1, 0)]
    assert calls[1][1][0] == 131070 * 2 * 2 * 8 * 8


# --- the fused path's pieces --------------------------------------------------

def test_bsk_to_planes_matches(ctx_2bit, tctx_2bit):
    want = np.asarray(jfused.bsk_to_planes(ctx_2bit.bsk_f))
    got = fused_pbs.bsk_to_planes(tctx_2bit.bsk_f)
    assert got.dtype == torch.float64 and got.is_contiguous()
    assert np.array_equal(got.numpy(), want)


def test_keyswitch_fused_bit_identical(ctx_2bit, tctx_2bit, pallas_engine_2bit):
    """The keyswitch through the port's pack (int8 digits, limb operand)
    against the JAX package's pack, bit for bit."""
    p = ctx_2bit.params
    key = jax.random.PRNGKey(3)
    cts = jnp.stack([ctx_2bit.encrypt(jax.random.fold_in(key, i), i % 4) for i in range(5)])
    want = np.asarray(pallas_engine_2bit.fused_pack.keyswitch(cts))
    pack = fused_pbs.FusedPbsPack.build(tctx_2bit.bsk_f, tctx_2bit.ksk, p)
    tcts = u64_to_tensor(np.asarray(cts), "cpu")
    assert np.array_equal(tensor_to_u64(pack.keyswitch(tcts)), want)
    assert np.array_equal(tensor_to_u64(fused_pbs.keyswitch_fused(tcts, pack.ksk_limbs, p)),
                          want)


def test_keyswitch_fused_refuses_digits_wider_than_int8(tctx_2bit):
    p = dataclasses.replace(tctx_2bit.params, ks_base_log=9, ks_level=3)
    cts = torch.zeros((2, p.big_n + 1), dtype=torch.int64)
    limbs = torch.zeros((8 * (p.n + 1), p.big_n * 3), dtype=torch.uint8)
    with pytest.raises(ValueError, match="ks_base_log 9 > 8"):
        fused_pbs.keyswitch_fused(cts, limbs, p)


def test_external_product_planes_matches(ctx_2bit, tctx_2bit):
    """One external product from the same inputs: the torus results agree
    to within the f64 transform rounding.  The coefficients before the
    fold onto the torus reach about 2^85, where one f64 ulp is 2^33; the
    bound 2^40 is still 2^21 below delta = 2^61."""
    p = ctx_2bit.params
    glwe_cts = np.random.default_rng(11).integers(0, 2 ** 64, (3, p.k + 1, p.N),
                                                  dtype=np.uint64)
    jplanes = jfused.bsk_to_planes(ctx_2bit.bsk_f)
    want = np.asarray(jfused.external_product_planes(jplanes[5], jnp.asarray(glwe_cts), p))
    got = fused_pbs.external_product_planes(fused_pbs.bsk_to_planes(tctx_2bit.bsk_f)[5],
                                            u64_to_tensor(glwe_cts, "cpu"), p)
    diff = (tensor_to_u64(got) - want).view(np.int64)
    assert np.abs(diff).max() < 2 ** 40
