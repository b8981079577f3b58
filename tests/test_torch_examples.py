"""The port's six demos (`repro_torch.examples`) on the CPU.

The three that finish within about a minute on the port's plain CPU path
(quickstart, serve_requests, sim_scenario) run whole: each must print its
got/expect lines with every got equal to its want.  The other three
(encrypted_int32, fhe_gpt2, trace_serve: tens of radix rounds at 4-bit
parameters, minutes of CPU) run on the card in `chip_smoke.py`; here their
oracles' want values are held to the JAX package's: the same lowering,
quantization and plaintext functions on the same inputs.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.examples import (checked_lines, encrypted_int32, fhe_gpt2,  # noqa: E402
                                  got_expect, quickstart, serve_requests, sim_scenario,
                                  trace_serve)
from torch_threads import two_torch_threads  # noqa: E402,F401


@pytest.mark.parametrize("demo,argv,lines", [
    (quickstart, [], 4), (serve_requests, [], 4), (sim_scenario, ["--out"], 1)])
def test_demo_runs_on_the_cpu(demo, argv, lines, capsys, tmp_path):
    if argv == ["--out"]:
        argv = ["--out", str(tmp_path / "report.json")]
    assert demo.main(["--device", "cpu", *argv]) == 0
    checks = checked_lines(capsys.readouterr().out)
    assert len(checks) >= lines
    for line, got, want in checks:
        assert got == want, line


def test_quickstart_and_int32_oracles_are_the_reference_demos():
    assert quickstart.wants() == {"a+b": 14, "2a+b": 3, "a^2": 9, "relu(a+b-8)": 6}
    w = encrypted_int32.wants()
    a, b = 51234, 17777                      # examples/encrypted_int32.py
    assert w == {"x": 0xDEADBEEF, "a+b": (a + b) % 2 ** 16, "a*b": (a * b) % 2 ** 16,
                 "b-a": (b - a) % 2 ** 16, "relu(-1234)": 0, "relu(+1234)": 1234,
                 "compare": 2, "a<b": 0}
    assert serve_requests.wants() == [126, 239, 0, 126]


def test_fhe_gpt2_oracles_match_the_reference():
    from repro.core.params import TEST_PARAMS_6BIT
    from repro.fhe_ml import executor as jexecutor, lower as jlower
    from repro.fhe_ml.quantize import QuantSpec, calibrate_radix, quantize_to_radix
    g, x, want = fhe_gpt2.narrow_inputs()
    jg, _ = jlower.lower_gpt2_block(4, QuantSpec(3, 0.25, 4), TEST_PARAMS_6BIT.width, seed=1)
    jwant = jexecutor.interpret(jg, [np.random.default_rng(0).integers(0, 8, (4,))],
                                TEST_PARAMS_6BIT.width)[jg.outputs[0]]
    np.testing.assert_array_equal(np.asarray(want), np.asarray(jwant))

    _, _, xf, rq, q, want = fhe_gpt2.radix_inputs()
    _, jmeta = jlower.lower_gpt2_block_radix(2, bits=16, msg_bits=2, seed=1)
    jxf = np.random.default_rng(3).uniform(-1, 1, size=(2,))
    jq = quantize_to_radix(jxf, calibrate_radix(jxf, 16, 2, qmax=jmeta["input_qmax"]))
    np.testing.assert_array_equal(q, jq)
    np.testing.assert_array_equal(want, np.asarray(jmeta["int_fn"](jq)) % (1 << 16))


def test_trace_serve_oracles_match_the_reference():
    from repro.fhe_ml import lower as jlower
    from repro.fhe_ml.quantize import calibrate_radix, quantize_to_radix
    adds, _, _, q, wants = trace_serve.plaintexts()
    rng = np.random.default_rng(3)           # examples/trace_serve.py's draws
    jadds = [(int(rng.integers(0, 1 << 16)), int(rng.integers(0, 1 << 16))) for _ in range(2)]
    _, jmeta = jlower.lower_gpt2_block_radix(2, bits=16, msg_bits=2, seed=1)
    xf = rng.uniform(-1, 1, 2)
    jq = quantize_to_radix(xf, calibrate_radix(xf, 16, 2, qmax=jmeta["input_qmax"]))
    assert adds == jadds
    np.testing.assert_array_equal(q, jq)
    assert wants[:2] == [(a + b) % (1 << 16) for a, b in jadds]
    np.testing.assert_array_equal(wants[2], np.asarray(jmeta["int_fn"](jq)) % (1 << 16))


@pytest.mark.parametrize("line,got,want", [
    ("dec(a+b)    = 14   (expect 14)", [14], [14]),
    ("decrypt            = 0xDEADBEEF   (expect 0xDEADBEEF)", [0xDEADBEEF], [0xDEADBEEF]),
    ("dec(a+b) =  3475   (expect 3475; 5 PBS batches, min batch 8 of 8 digits)",
     [3475], [3475]),
    ("relu(-1234) = 0   (expect 0)", [0], [0]),
    ("compare(a, b) = 2   (0 eq / 1 lt / 2 gt; expect 2)", [2], [2]),
    ("traced/eager: a+b=3475, a*b=33026, [a<b]=0   (expect 3475, 33026, 0)",
     [3475, 33026, 0], [3475, 33026, 0]),
    ("  bob    request 1: dec = 239 (expect 239) ok", [239], [239]),
    ("decrypted (serve) = 1 65535 7   (expect 1 65535 8)", [1, 65535, 7], [1, 65535, 8]),
])
def test_got_expect_lines_parse(line, got, want):
    assert got_expect(line) == (got, want)
