"""CPU tests of the benchmark harness: the client's keys and ciphers,
the programs' plaintext semantics, the frozen counts, the traffic
generator, a whole run's last line on a stand-in PBS, the faults that
must make `correct` false, the control, and the import check."""
import json
import random
import subprocess
import sys

import numpy as np
import pytest
import torch

from perfbench import client, generator, harness, reference_pbs
from perfbench.counts import pbs as counts
from perfbench.programs import radix_add, radix_mul
from perfbench.tests import standin

GPT2 = client.Params(1003, 32768, 1, 6, 22, 1, 3, 6, 1.9985099549363734e-08,
                     4.440892098500626e-16)
# big enough for a real PBS to decrypt, small enough for the CPU
SMALL = {"n": 48, "N": 1024, "k": 1, "width": 4, "pbs_base_log": 15, "pbs_level": 2,
         "ks_base_log": 4, "ks_level": 5, "lwe_std": 2.0 ** -45, "glwe_std": 2.0 ** -45,
         "padding_bits": 1}


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_negacyclic_product_is_exact():
    gen = torch.Generator().manual_seed(1)
    a = client.random_torus(gen, (3, 1, 64))
    s = torch.randint(0, 2, (1, 64), generator=gen)
    got = client.negacyclic_mul_binary(a, s)
    want = torch.zeros(3, 64, dtype=torch.int64)
    for i in range(64):
        for j in range(64):
            if s[0, j]:
                k = i + j
                term = a[:, 0, i] if k < 64 else -a[:, 0, i]
                want[:, k % 64] += term
    assert torch.equal(got, want)


def test_encrypt_decrypt_round_trip():
    p = client.Params(**standin.TINY)
    gen = torch.Generator().manual_seed(2)
    keys = client.keygen(p, gen)
    msgs = torch.randint(0, p.modulus, (100,), generator=gen)
    m, ph = client.decrypt(keys, client.encrypt(keys, gen, msgs))
    assert torch.equal(m, msgs)
    assert float(client.noise_share(keys, ph, msgs).max()) < 1e-6
    # the key-switching key decrypts to big_sk[i] * g_l under the small key
    ksk = keys.ksk
    ph = ksk[..., -1] - (ksk[..., :-1] * keys.lwe_sk).sum(-1)
    want = keys.big_sk[:, None] * client.gadget(p.ks_base_log, p.ks_level, "cpu")
    assert float((ph - want).double().abs().max()) < 2.0 ** 64 * 2.0 ** -40


RADIX = {"integer": {"bits": 8, "msg_bits": 2}}


@pytest.mark.parametrize("mod, a, b, want", [
    (radix_add, 200, 123, (200 + 123) % 256), (radix_add, 255, 1, 0),
    (radix_mul, 13, 17, 221), (radix_mul, 200, 123, (200 * 123) % 256)])
def test_radix_oracles(mod, a, b, want):
    digits = mod.expected_messages([a, b], RADIX)[0]
    assert sum(d << (2 * i) for i, d in enumerate(digits)) == want
    assert all(0 <= d < 4 for d in digits)
    assert mod.input_messages([a, b], RADIX) == [[(a >> 2 * i) & 3 for i in range(4)],
                                                 [(b >> 2 * i) & 3 for i in range(4)]]


@pytest.mark.parametrize("mod", [radix_add, radix_mul])
def test_frozen_pbs_counts_match_the_served_plan(mod):
    spec = standin.tiny_spec(clients=1, stagger_groups=1, pool_per_client=3, lead_rounds=1,
                             mix={mod.__name__.rsplit(".", 1)[1]: 1})
    keep = {}
    harness.run_cell(standin.CELL, 4, 0.5, False, device="cpu", spec=spec,
                     engine_hook=standin.standin_hook, log=lambda *a: None, keep=keep)
    run = keep["run"]
    done = run.delta("serve.completed")
    assert done > 0 and run.delta("sched.logical_luts") == done * mod.PBS


def test_frozen_counts_reproduce_the_smoke_bounds():
    mb = lambda bf: bf[0] / 1e6  # noqa: E731
    assert mb(counts.fft_forward_digits(GPT2, 12)) == pytest.approx(12.58, abs=0.005)
    assert mb(counts.fft_forward_digits(GPT2, 288)) == pytest.approx(301.99, abs=0.005)
    assert mb(counts.fft_inverse_torus(GPT2, 288)) == pytest.approx(452.98, abs=0.005)
    assert mb(counts.external_product_mac(GPT2, 288)) == pytest.approx(303.04, abs=0.005)
    h100 = counts.card_peaks("NVIDIA H100 80GB HBM3")
    assert counts.round_flops(GPT2, 12) / h100.fp64_flops * 1e3 == pytest.approx(0.918, abs=5e-4)
    assert counts.round_bytes_major(GPT2, 12) / h100.mem_bw * 1e3 == pytest.approx(0.788, abs=5e-4)
    assert counts.key_bytes(GPT2) / 1e9 == pytest.approx(2.63, abs=0.005)


def test_traffic_is_seeded_and_every_seed_gets_the_same_work():
    t = {"kind": "closed", "mix": {"a": 2, "b": 1}}
    one = generator.client_programs(t, 3, 9, 11)
    assert one == generator.client_programs(t, 3, 9, 11)
    assert one.count("b") == 3 and one.count("a") == 6
    assert [generator.client_programs(t, c, 3, 11) for c in range(8)] != \
        [generator.client_programs(t, c, 3, 12) for c in range(8)]
    rng = lambda seed: generator.seeded_rng("values", seed, ("closed", 2, 5))  # noqa: E731
    cfg = harness.cell_spec(standin.CELL)["config"]
    assert radix_add.sample(rng(11), cfg) == radix_add.sample(rng(11), cfg)
    assert radix_add.sample(rng(11), cfg) != radix_add.sample(rng(12), cfg)


LOAD = dict(clients=12, pool_per_client=4, lead_rounds=2)


@pytest.mark.parametrize("trace", [False, True])
def test_last_line_on_a_standin_pbs(trace):
    spec = standin.tiny_spec(**LOAD)
    res = standin.run(trace=trace, spec=spec)
    assert list(res) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert res["correct"] and res["attempted"] > 0 and res["failed"] == 0
    listed = {m["name"]: dict(m, source=m.get("source", "host_clock"))
              for m in spec["per_layer" if trace else "end_to_end"]}
    # the device trace and the card's peaks exist only on the card
    host_only = {n for n, m in listed.items() if m["source"] != "device_trace" and "mfu" not in n}
    assert host_only <= set(res["metrics"]) <= set(listed)
    for name, m in res["metrics"].items():
        assert m["unit"] == listed[name]["unit"] and m["value"] >= 0
    assert list(res["checks"]) == ["unserved_requests", "wrong_outputs", "worst_noise_share"]
    json.dumps(res)


def _faulty(kind):
    def hook(engine, keys):
        good = standin.standin_lut_batch(keys, torch.Generator().manual_seed(7))

        def lut_batch(cts, polys):
            if kind == "unchanged":          # the step returns its state
                return cts
            out = good(cts, polys)
            if kind == "half":               # half of the batch left out
                out[(cts.shape[0] + 1) // 2:] = 0
            if kind == "altered":            # an answer altered where produced
                out[0, -1] += keys.params.delta
            return out
        standin.install(engine, keys, lut_batch)
    return hook


@pytest.mark.parametrize("fault", ["unchanged", "half", "altered"])
def test_a_broken_pbs_is_not_correct(fault):
    res = standin.run(hook=_faulty(fault), **LOAD)
    assert not res["correct"]
    assert res["checks"]["wrong_outputs"]["value"] > 0


@pytest.mark.parametrize("dtype, correct", [(torch.float64, True), (torch.float32, False)])
def test_reference_pbs_in_place_and_its_float32_control(dtype, correct):
    spec = standin.tiny_spec(params=SMALL, clients=2, stagger_groups=1, pool_per_client=2,
                             lead_rounds=1)
    res = standin.run(seconds=0.5, spec=spec,
                      hook=lambda e, k: reference_pbs.install(e, k, dtype))
    assert res["correct"] is correct
    share = res["checks"]["worst_noise_share"]["value"]
    assert (share < 0.1) if correct else (share > 1.0)


def test_runs_load_no_jax(tmp_path):
    code = (
        "import sys; sys.path[:0] = [%r, %r, %r]\n"
        "import standin\n"
        "standin.run(seconds=0.5, clients=2, pool_per_client=2, lead_rounds=1)\n"
        "print(sorted({m.split('.')[0] for m in sys.modules} & {'jax', 'jaxlib', 'flax', 'repro'}))\n"
        % (str(harness.ROOT), str(harness.ROOT / "src"), str(harness.HERE / "tests")))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=tmp_path)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_run_refuses_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    out = subprocess.run([sys.executable, str(harness.HERE / "run.py"), "--workload",
                          standin.CELL, "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=300, cwd=tmp_path)
    assert out.returncode != 0 and out.stdout.strip() == ""
