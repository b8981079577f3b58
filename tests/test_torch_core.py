"""The port's scheme core (`repro_torch.core`) against the JAX reference.

Integer stages are held bit for bit: the same numpy inputs (or the JAX
context's keys, carried across by `repro_torch.interop`) go through the
JAX function and its port, and the uint64 bits must match.  The FFT is
held to 1e-12 of the spectrum scale.
"""
import ast
import dataclasses
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import decompose as jdec, fft as jfft, glwe as jglwe  # noqa: E402
from repro.core import lwe as jlwe, noise as jnoise, torus as jtorus  # noqa: E402
from repro.core import params as jparams  # noqa: E402
from repro_torch.core import batch, decompose as dec, fft, glwe, lwe, params, torus  # noqa: E402
from repro_torch.core.pbs import TFHEContext  # noqa: E402
from repro_torch.interop import context_from_numpy, tensor_to_u64, u64_to_tensor  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401

PARAM_NAMES = ["TEST_PARAMS", "TEST_PARAMS_4BIT", "TEST_PARAMS_6BIT", "TEST_PARAMS_K2"]
CORNERS = np.array([0, 1, 2 ** 31, 2 ** 32 - 1, 2 ** 32, 2 ** 63 - 1, 2 ** 63,
                    2 ** 63 + 1, 2 ** 64 - 1, 2 ** 64 - 2 ** 32], dtype=np.uint64)


def t(a):
    return u64_to_tensor(np.asarray(a), "cpu")


def u64(x):
    return tensor_to_u64(x)


def rand_u64(seed, shape):
    return np.random.default_rng(seed).integers(0, 2 ** 64, shape, dtype=np.uint64)


@pytest.fixture(scope="module")
def tctx_2bit(ctx_2bit):
    arrays = {k: np.asarray(getattr(ctx_2bit, k))
              for k in ("lwe_sk", "glwe_sk", "big_sk", "ksk", "bsk_f")}
    return context_from_numpy(dataclasses.asdict(ctx_2bit.params), arrays, "cpu")


def jax_cts(ctx, B, seed=97):
    key = jax.random.PRNGKey(seed)
    msgs = np.arange(B) % ctx.params.plaintext_modulus
    cts = jnp.stack([ctx.encrypt(jax.random.fold_in(key, i), int(m))
                     for i, m in enumerate(msgs)])
    return cts, msgs


# --- params -------------------------------------------------------------------

@pytest.mark.parametrize("name", PARAM_NAMES + sorted(jparams.PAPER_PARAMS))
def test_params_equal_field_by_field(name):
    want = (getattr(jparams, name) if name in PARAM_NAMES
            else jparams.PAPER_PARAMS[name])
    got = (getattr(params, name) if name in PARAM_NAMES
           else params.PAPER_PARAMS[name])
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert (got.big_n, got.delta, got.log2_N, got.plaintext_modulus) == \
        (want.big_n, want.delta, want.log2_N, want.plaintext_modulus)


# --- torus --------------------------------------------------------------------

@pytest.mark.parametrize("name", PARAM_NAMES + ["gpt2"])
def test_torus_encode_decode_bit_identical(name):
    p = getattr(params, name) if name in PARAM_NAMES else params.PAPER_PARAMS[name]
    msgs = np.arange(p.plaintext_modulus * 3, dtype=np.uint64)
    assert np.array_equal(u64(torus.encode(torch.as_tensor(msgs.astype(np.int64)), p.delta)),
                          np.asarray(jtorus.encode(jnp.asarray(msgs), p.delta)))
    vals = np.concatenate([rand_u64(p.N, 4096), CORNERS])
    got = torus.decode(t(vals), p.delta, p.plaintext_modulus).numpy()
    want = np.asarray(jtorus.decode(jnp.asarray(vals), p.delta, p.plaintext_modulus))
    assert np.array_equal(got.astype(np.uint64), want)


def test_float_to_torus_bit_identical():
    rng = np.random.default_rng(5)
    x = np.concatenate([
        rng.standard_normal(2000) * 2.0 ** rng.integers(0, 94, 2000),
        np.array([0.5, 1.5, 2.5, -0.5, -1.5, 2.0 ** 32 + 0.5, -(2.0 ** 33) - 0.5,
                  2.0 ** 63, -(2.0 ** 63), 2.0 ** 64 + 2.0 ** 40, 2.0 ** 94]),
    ])
    got = u64(torus.float_to_torus(torch.as_tensor(x, dtype=torch.float64)))
    want = np.asarray(jtorus.float_to_torus(jnp.asarray(x)))
    assert np.array_equal(got, want)


def test_random_torus_spans_64_bits():
    g = torch.Generator().manual_seed(0)
    v = u64(torus.random_torus(g, (4096,)))
    assert (v >> np.uint64(63)).any() and not (v >> np.uint64(63)).all()
    assert ((v & np.uint64(0xFFFFFFFF)) >> np.uint64(31)).any()


# --- decompose ----------------------------------------------------------------

@pytest.mark.parametrize("base_log,level", [
    (4, 5), (5, 5), (6, 4), (3, 6), (12, 2), (14, 2), (22, 1), (23, 1),
    (16, 4), (8, 8), (32, 2), (1, 64)])   # the last four: shift == 0
def test_decompose_bit_identical(base_log, level):
    v = np.concatenate([rand_u64(base_log * 100 + level, (64, 33)).ravel(), CORNERS])
    got = dec.decompose(t(v), base_log, level)
    want = np.asarray(jdec.decompose(jnp.asarray(v), base_log, level))
    assert np.array_equal(got.numpy(), want)
    back = np.asarray(jdec.recompose(jnp.asarray(want), base_log, level))
    assert np.array_equal(u64(dec.recompose(got, base_log, level)), back)


# --- lwe ----------------------------------------------------------------------

@pytest.mark.parametrize("log2_2N", [10, 12, 13, 16])
def test_mod_switch_bit_identical(log2_2N):
    v = np.concatenate([rand_u64(log2_2N, 5000), CORNERS])
    got = lwe.mod_switch(t(v), log2_2N)
    want = np.asarray(jlwe.mod_switch(jnp.asarray(v), log2_2N))
    assert np.array_equal(u64(got), want)


def test_keyswitch_bit_identical(ctx_2bit, tctx_2bit):
    p = ctx_2bit.params
    cts, _ = jax_cts(ctx_2bit, 5)
    want = np.asarray(jlwe.keyswitch(cts, ctx_2bit.ksk, p.ks_base_log, p.ks_level))
    got = lwe.keyswitch(t(cts), tctx_2bit.ksk, p.ks_base_log, p.ks_level)
    assert np.array_equal(u64(got), want)


def test_decrypt_and_linear_ops_match(ctx_2bit, tctx_2bit):
    cts, msgs = jax_cts(ctx_2bit, 8)
    tc = t(cts)
    assert tctx_2bit.decrypt(tc).tolist() == [int(ctx_2bit.decrypt(c)) for c in cts]
    assert np.array_equal(u64(lwe.decrypt_phase(tctx_2bit.big_sk, tc)),
                          np.asarray(jlwe.decrypt_phase(ctx_2bit.big_sk, cts)))
    assert np.array_equal(u64(lwe.add(tc, tc)), np.asarray(jlwe.add(cts, cts)))
    assert np.array_equal(u64(lwe.sub(tc, tc.flip(0))), np.asarray(jlwe.sub(cts, cts[::-1])))
    assert np.array_equal(u64(lwe.scalar_mul(tc, -3)), np.asarray(jlwe.scalar_mul(cts, -3)))
    m = np.uint64(ctx_2bit.params.delta)
    assert np.array_equal(u64(lwe.add_plain(tc, int(m))), np.asarray(jlwe.add_plain(cts, m)))
    assert np.array_equal(u64(lwe.trivial(t(CORNERS), 7)),
                          np.asarray(jlwe.trivial(jnp.asarray(CORNERS), 7)))


# --- glwe ---------------------------------------------------------------------

@pytest.mark.parametrize("N", [256, 512])
def test_rotate_and_sample_extract_bit_identical(N):
    ct = rand_u64(N, (3, 2, N))
    for r in (0, 1, N - 1, N, N + 5, 2 * N - 1):
        want = np.asarray(jglwe.rotate(jnp.asarray(ct), jnp.asarray(r), N))
        assert np.array_equal(u64(glwe.rotate(t(ct), r, N)), want)
    rs = np.array([0, N + 3, 2 * N - 1])
    want = np.stack([np.asarray(jglwe.rotate(jnp.asarray(ct[i]), jnp.asarray(r), N))
                     for i, r in enumerate(rs)])
    assert np.array_equal(u64(batch.rotate_batch(t(ct), torch.as_tensor(rs), N)), want)
    assert np.array_equal(u64(glwe.sample_extract(t(ct))),
                          np.asarray(jglwe.sample_extract(jnp.asarray(ct))))
    assert np.array_equal(u64(glwe.trivial(t(ct[:, 0]), 2)),
                          np.asarray(jglwe.trivial(jnp.asarray(ct[:, 0]), 2)))


@pytest.mark.parametrize("name", PARAM_NAMES)
def test_make_lut_polys_bit_identical(name):
    p = getattr(params, name)
    jp = getattr(jparams, name)
    rng = np.random.default_rng(p.N)
    tables = rng.integers(0, p.plaintext_modulus, (4, p.plaintext_modulus))
    tables[2] = tables[0]
    want = np.asarray(jglwe.make_lut_polys(jnp.asarray(tables, dtype=jnp.uint64), jp))
    assert np.array_equal(u64(glwe.make_lut_poly(tables[1], p)), want[1])
    glwe.clear_row_poly_cache()
    assert np.array_equal(u64(glwe.make_lut_polys_cached(tables, p)), want)
    assert glwe.row_poly_cache_stats() == {"hits": 0, "misses": 3, "evictions": 0}
    assert np.array_equal(u64(glwe.make_lut_polys_cached(torch.as_tensor(tables), p)), want)
    assert glwe.row_poly_cache_stats()["hits"] == 3


# --- fft ----------------------------------------------------------------------

@pytest.mark.parametrize("N", [256, 2048, 32768])
def test_fft_matches_reference(N):
    rng = np.random.default_rng(N)
    x = rng.integers(-2 ** 40, 2 ** 40, (3, N))
    want = np.asarray(jfft.forward(jnp.asarray(x)))
    got = fft.forward(torch.as_tensor(x)).numpy()
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12 * scale)
    back = fft.inverse(torch.tensor(want)).numpy()
    np.testing.assert_allclose(back, np.asarray(jfft.inverse(jnp.asarray(want))),
                               rtol=0, atol=1e-12 * scale)
    # torus-valued inputs are read as signed int64, as the reference does
    v = rand_u64(N + 1, (2, N))
    np.testing.assert_allclose(fft.forward(t(v)).numpy(),
                               np.asarray(jfft.forward(jnp.asarray(v))),
                               rtol=0, atol=1e-12 * 2.0 ** 63 * N)


# --- the port's own keygen ----------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1])
def test_own_keygen_encrypt_lut_decrypt(seed):
    p = params.TEST_PARAMS
    g = torch.Generator().manual_seed(seed)
    ctx = TFHEContext.create(g, p, device="cpu")
    assert ctx.bsk_f.shape == (p.n, p.k + 1, p.pbs_level, p.k + 1, p.N // 2)
    assert ctx.ksk.shape == (p.big_n, p.ks_level, p.n + 1)
    msgs = torch.arange(p.plaintext_modulus)
    cts = ctx.encrypt(g, msgs)
    assert ctx.decrypt(cts).tolist() == msgs.tolist()
    table = [(3 * v + 1) % p.plaintext_modulus for v in range(p.plaintext_modulus)]
    outs = torch.stack([ctx.lut(c, table) for c in cts])
    assert ctx.decrypt(outs).tolist() == [table[m] for m in msgs.tolist()]
    # output noise within the reference's variance model (6 sigma)
    noise = ctx.decrypt_noise(outs, torch.as_tensor([table[m] for m in msgs.tolist()]))
    assert noise.abs().max().item() < 6 * np.sqrt(jnoise.pbs_out_var(jparams.TEST_PARAMS))
    # fresh-encryption noise has the configured std
    fresh = ctx.decrypt_noise(ctx.encrypt(g, torch.zeros(4096, dtype=torch.int64)), 0)
    assert 0.8 * p.glwe_std < fresh.std().item() < 1.2 * p.glwe_std


def test_context_without_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TFHEContext.create(torch.Generator(), params.TEST_PARAMS)


# --- import boundary ----------------------------------------------------------

def test_port_imports_neither_jax_nor_repro():
    # jax and repro are made unimportable, not just absent from sys.modules
    code = (
        "import importlib, pkgutil, sys\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in ('jax', 'repro'):\n"
        "            raise ImportError(f'{name} is blocked')\n"
        "sys.meta_path.insert(0, Block())\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "bad = sorted(k for k in sys.modules if k == 'jax' or k.startswith('jax.')"
        " or k == 'repro' or k.startswith('repro.'))\n"
        "print(len([k for k in sys.modules if k.startswith('repro_torch')]), bad)\n"
        "assert not bad, bad\n")
    import pathlib
    root = pathlib.Path(__file__).resolve().parents[1]
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=root, env={"PYTHONPATH": f"{root / 'src'}:{root}",
                                        "PATH": "/usr/bin:/bin"}, timeout=120)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.split()[0]) >= 56


# --- test layer ---------------------------------------------------------------

PORT_TEST_FILES = sorted(Path(__file__).parent.glob("test_torch_*.py"))


@pytest.mark.parametrize("path", PORT_TEST_FILES, ids=[p.name for p in PORT_TEST_FILES])
def test_port_test_file_takes_the_shared_thread_pin(path):
    """Each port test file imports exactly one pin from `torch_threads` and
    sets torch's threads nowhere itself (a subprocess script is a string)."""
    tree = ast.parse(path.read_text())
    pins = [a.name for node in tree.body
            if isinstance(node, ast.ImportFrom) and node.module == "torch_threads"
            for a in node.names]
    assert pins in (["one_torch_thread"], ["two_torch_threads"]), pins
    calls = [node.lineno for node in ast.walk(tree) if isinstance(node, ast.Call)
             and getattr(node.func, "attr", getattr(node.func, "id", None)) == "set_num_threads"]
    assert not calls, f"set_num_threads called at lines {calls}"
