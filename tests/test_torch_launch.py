"""The port's launch layer (`repro_torch.launch.roofline`, `pbs_dryrun`)
against `repro.launch.roofline` and `repro.launch.pbs_dryrun`.

The per-round traffic model and the PBS FLOP count equal the
reference's for every parameter set, and the LM stack's `model_flops`
for every arch and shape; the port's resident pack streams
no more than the model per round; the per-kernel byte counts equal the
bytes of the tensors the kernels take (what `chip_smoke.py`'s bounds
count).  The reference's `pbs_dryrun` sets a 512-device XLA flag when
imported, so its `pbs_flops` is read from its source alone.  Tolerance:
exact.
"""
import ast
import dataclasses
import importlib
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import repro.configs as jconfigs  # noqa: E402
from repro.core import params as jparams  # noqa: E402
from repro.launch import roofline as jrl  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.configs import ARCH_IDS  # noqa: E402
from repro_torch.core import decompose as dec, params, torus  # noqa: E402
from repro_torch.core.engine import TaurusEngine  # noqa: E402
from repro_torch.kernels import fourstep_fft as ff, external_product as ep  # noqa: E402
from repro_torch.launch import pbs_dryrun, roofline as rl  # noqa: E402
from repro_torch.launch.train import reduced_config  # noqa: E402
from test_torch_api import port_context  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401

ROOT = Path(__file__).resolve().parents[1]
SETS = sorted(params.PAPER_PARAMS) + ["TEST_PARAMS", "TEST_PARAMS_4BIT", "TEST_PARAMS_6BIT",
                                       "TEST_PARAMS_K2"]


def both(name):
    if name in params.PAPER_PARAMS:
        return params.PAPER_PARAMS[name], jparams.PAPER_PARAMS[name]
    return getattr(params, name), getattr(jparams, name)


def reference_pbs_flops():
    """The reference's `pbs_flops`, compiled from its source on its own."""
    path = ROOT / "src" / "repro" / "launch" / "pbs_dryrun.py"
    fn = next(n for n in ast.parse(path.read_text()).body
              if isinstance(n, ast.FunctionDef) and n.name == "pbs_flops")
    scope = {}
    exec(compile(ast.Module([fn], []), str(path), "exec"), scope)
    return scope["pbs_flops"]


MODEL_FIELDS = ("bsk_bytes", "ksk_bytes", "ct_in_bytes", "ct_out_bytes", "lut_bytes",
                "batch", "key_bytes", "per_ct_bytes", "fused_bytes", "unfused_bytes",
                "reuse_factor", "arithmetic_intensity_keys")


@pytest.mark.parametrize("B", [1, 12, 192])
@pytest.mark.parametrize("name", SETS)
def test_pbs_round_model_equals_reference(name, B):
    p, jp = both(name)
    got, want = rl.pbs_round_model(p, B), jrl.pbs_round_model(jp, B)
    assert {f: getattr(got, f) for f in MODEL_FIELDS} == \
        {f: getattr(want, f) for f in MODEL_FIELDS}
    # the memory term is the card's: the same bytes over its memory rate
    assert got.t_memory == got.fused_bytes / rl.H100_SXM.mem_bw
    assert set(got.to_dict()) == set(want.to_dict())


@pytest.mark.parametrize("name", SETS)
def test_pbs_flops_equals_reference(name):
    p, jp = both(name)
    ref = reference_pbs_flops()
    for B in (1, 12, 192):
        assert pbs_dryrun.pbs_flops(p, B) == ref(jp, B)


def test_roofline_terms_on_the_card():
    """The reference's fields and properties, over the card's peaks."""
    roof = rl.from_counts(2.0e12, 6.7e9, model_flops=1.0e12, hbm_bytes_major=3.35e9)
    assert [f.name for f in dataclasses.fields(jrl.Roofline)] == \
        [f.name for f in dataclasses.fields(rl.Roofline)][:-2]
    assert roof.t_compute == 2.0e12 / 67e12 and roof.t_memory == 6.7e9 / 3.35e12
    assert roof.t_memory_major == 1e-3 and roof.t_collective == 0.0
    assert roof.bottleneck == "compute" and roof.t_bound == roof.t_compute
    assert roof.flops_ratio == 0.5 and roof.mfu_bound == pytest.approx(0.5, rel=1e-12)
    ref = jrl.Roofline(2.0e12, 6.7e9, 0.0, 1, {}, 1.0e12, 3.35e9)
    assert set(roof.to_dict()) == set(ref.to_dict())
    # the LM stack's matmuls run at the bf16 tensor-core peak
    lm = rl.from_counts(9.89e12, 6.7e9, model_flops=9.89e12, compute_peak="bf16_flops")
    assert lm.t_compute == 0.01 and lm.bottleneck == "compute"
    assert lm.mfu_bound == pytest.approx(1.0, rel=1e-12)


@pytest.mark.parametrize("smi,want", [
    ("NVIDIA H100 80GB HBM3", (3.35e12, 67e12, 1979e12, 989e12)),
    ("NVIDIA H100 PCIe", (2.0e12, 51.2e12, 1513e12, 756e12)),
    ("NVIDIA H100 NVL", (3.9e12, 60e12, 1671e12, 835e12))])
def test_card_peaks(smi, want):
    assert tuple(rl.card_peaks(smi)) == want
    with pytest.raises(RuntimeError, match="no data-sheet peaks"):
        rl.card_peaks("NVIDIA A100-SXM4-80GB")


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_model_flops_equals_reference(arch):
    """Every arch x shape cell, the full config and the reduced one."""
    mod = arch.replace("-", "_").replace(".", "_")
    for cfg, jcfg in ((configs.get(arch), jconfigs.get(arch)),
                      (reduced_config(arch), importlib.import_module(
                          f"repro.configs.{mod}").reduced())):
        for name, shape in configs.SHAPES.items():
            assert rl.model_flops(cfg, shape) == jrl.model_flops(jcfg, jconfigs.SHAPES[name])


@pytest.fixture(scope="module")
def fused_2bit(ctx_2bit):
    return TaurusEngine.from_context(port_context(ctx_2bit), device="cpu")


@pytest.mark.parametrize("B", [1, 12, 48])
def test_bytes_streamed_within_model(fused_2bit, engine_2bit, B):
    """The counterpart of tests/test_kernels.py's roofline gate: the
    resident pack streams no more per round than the model's fused bytes,
    and its key bytes are the engine's (and the JAX engine's)."""
    pack = fused_2bit.fused_pack
    model = rl.pbs_round_model(fused_2bit.params, B)
    assert pack.bytes_streamed_per_round(B) <= model.fused_bytes <= model.unfused_bytes
    assert (model.fused_bytes < model.unfused_bytes) == (B > 1)
    assert pack.resident_key_bytes == fused_2bit.key_bytes == engine_2bit.key_bytes
    assert model.key_bytes == sum(fused_2bit.key_bytes)


@pytest.mark.parametrize("rows", [1, 12])
def test_pbs_kernel_bytes_equal_operand_tensors(fused_2bit, rows):
    """`pbs_kernel_bytes` counts the bytes of the tensors each kernel takes
    and returns in a fused round, as the smoke run's bounds count them."""
    p, pack = fused_2bit.params, fused_2bit.fused_pack
    gen = torch.Generator().manual_seed(3)

    def nbytes(*ts):
        return sum(t.numel() * t.element_size() for t in ts)

    cts = torus.random_torus(gen, (rows, p.big_n + 1), device="cpu")
    digits = dec.decompose(cts[:, :-1], p.ks_base_log, p.ks_level).reshape(rows, -1)
    digits = digits.to(torch.int8)
    acc = torus.random_torus(gen, (rows, p.k + 1, p.N), device="cpu")
    shifts = torch.randint(0, 2 * p.N, (rows,), generator=gen)
    dig = ff.fft_forward_digits(acc, shifts, p.pbs_base_log, p.pbs_level)
    mac = ep.external_product_mac(dig, pack.bsk_planes[0])
    T = pack.ksk_limbs.shape[0] // 8
    assert rl.pbs_kernel_bytes(p, rows) == {
        "keyswitch_mac": nbytes(digits, pack.ksk_limbs) + rows * T * 8,
        "fft_forward_digits": nbytes(acc, shifts, dig),
        "external_product_mac": nbytes(dig, pack.bsk_planes[0], mac),
        "fft_inverse_torus": nbytes(mac, acc, acc)}


def test_pbs_dryrun_rows_at_gpt2():
    """The two variants at gpt2, B = 12: the same FLOPs; bytes that differ
    by the keys streamed 11 more times; the per-ciphertext loop's bound
    per PBS the larger."""
    p = params.PAPER_PARAMS["gpt2"]
    bat, xpu = pbs_dryrun.run("gpt2", 12)
    model = rl.pbs_round_model(p, 12)
    assert (bat["variant"], xpu["variant"]) == ("taurus-batched", "xpu-per-ct")
    assert bat["flops"] == xpu["flops"] == pbs_dryrun.pbs_flops(p, 12)
    assert xpu["hbm_bytes"] - bat["hbm_bytes"] == 11 * model.key_bytes
    assert (bat["hbm_bytes"] - model.fused_bytes
            == pbs_dryrun.operand_bytes(p, 12) == 12 * pbs_dryrun.operand_bytes(p, 1))
    assert bat["bottleneck"] == xpu["bottleneck"] == "memory"
    assert bat["per_pbs_bound_ms"] < xpu["per_pbs_bound_ms"]
    assert bat["chips"] == 1 and bat["coll_bytes"] == 0

