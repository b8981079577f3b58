"""The port's CUDA kernels against their plain PyTorch versions, on a card.

These tests need a CUDA device and skip without one.  The machine with
the card has no JAX, and `tests/conftest.py` imports it, so run them
there without the conftest:

    python -m pytest -q --noconftest tests/test_torch_cuda.py

Tolerances are the contract's: the keyswitch MAC bit-exact (int8
digits against the key's limb operand), the FFTs within 1e-12 of the
output scale, the MAC within 1e-9 relative, and the torus output of
`fft_inverse_torus` within 1e-12 of the float inverse's scale plus one
(the f64 transform's rounding, then one torus unit); through
`kernels.ops`, the f32 transforms within 2e-5 of the spectrum scale and
the f32 MAC within 1e-2 absolute (the reference's f32 gates), and the
keyswitch on int32 digits bit for bit;
PBS rounds, radix integer ops, the `fhe_ml` blocks and served waves
decrypt exactly to their oracles, and a PBS replayed from a captured
CUDA graph equals the eager launches' bit for bit (a wave to its programs' eager runs);
the quantize-to-radix MLP's floats stay within its `tol_fn`; the LM
stack's reduced configs (f32) give the CPU's forward hidden states and
decode logits within 1e-4 (summation order, carried by the
recurrences), and a full-width bf16 decode step the forward's logits
within an eighth of their largest magnitude (bf16 rounding over 2L
sub-layers; `chip_smoke.py`'s LM_BF16_TOL).  A reduced train step on the
card gives the CPU's loss (1e-4 relative) and updated parameters (1e-4
absolute but for a 1e-4 share of the elements, each within two steps of
lr: Adam's first step moves a parameter by lr g / (|g| + eps), so a
gradient near zero turns its rounding into a share of a whole step;
`chip_smoke.py`'s TRAIN_CARD_CPU_OUTLIERS); checkpoints restore card
tensors bit for bit; the
int8 compressor's `q` equals the CPU's away from rounding ties
(tests/test_torch_train.py's rule).
"""
import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro_torch.api import IntSpec, Session  # noqa: E402
from repro_torch.compiler.ir import radix_round_plan  # noqa: E402
from repro_torch.core.engine import TaurusEngine  # noqa: E402
from repro_torch.core.integer import IntegerContext  # noqa: E402
from repro_torch.core.params import TEST_PARAMS, TEST_PARAMS_4BIT, TEST_PARAMS_6BIT  # noqa: E402
from repro_torch.core.params import TEST_PARAMS_K2  # noqa: E402
from repro_torch.fhe_ml import QuantSpec, lower, quantize  # noqa: E402
from repro_torch.fhe_ml.executor import interpret  # noqa: E402
from repro_torch.core import torus  # noqa: E402
from repro_torch.core.pbs import TFHEContext  # noqa: E402
from repro_torch.kernels import external_product, fourstep_fft, keyswitch, ops  # noqa: E402
from repro_torch.kernels import launch_counts, reset_launch_counts  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.launch.steps import make_prefill_step  # noqa: E402
from repro_torch.launch.train import reduced_config  # noqa: E402
from repro_torch.models import build  # noqa: E402
from repro_torch.models.model import POS_SENTINEL  # noqa: E402
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.data import DataConfig, SyntheticLMData  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.launch.steps import make_train_step  # noqa: E402
from repro_torch.launch.serve import serve  # noqa: E402
from repro_torch.launch.train import train  # noqa: E402
from repro_torch.optim import AdamW, cosine_schedule  # noqa: E402
from repro_torch.runtime import Int8Compressor  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.Generator(device="cuda").manual_seed(7)


def close(got, want, rel):
    return (got - want).abs().max().item() <= rel * want.abs().max().item()


ROWS = [1, 12, 13, 33, 288]


@pytest.mark.parametrize("S,T", [(64, 33), (5000, 1004), (1023, 129), (70000, 7)])
@pytest.mark.parametrize("B", ROWS + [20, 100, 300])
def test_keyswitch_mac_bit_exact(gen, B, S, T):
    """Random int8 digits and int64 key words at the contract's row counts
    and in every row tier of the kernel (16, 32, 64, 144, 288, and two
    row groups at 300), with S and T off the kernel's tiles (S = 70,000
    spans two int32 stretches)."""
    d = torch.randint(-128, 128, (B, S), generator=gen, device="cuda").to(torch.int8)
    k = torch.randint(-(1 << 62), 1 << 62, (S, T), generator=gen, device="cuda") * 3
    limbs = keyswitch.ksk_limbs(k)
    reset_launch_counts()
    got = keyswitch.keyswitch_mac(d, limbs)
    assert launch_counts()["keyswitch_mac"] == 1
    assert torch.equal(got, keyswitch.keyswitch_mac_plain(d, limbs))


@pytest.mark.parametrize("digit", [-128, 127])
def test_keyswitch_mac_extremes(gen, digit):
    """The largest limb sums there are over S = 2 stretches + 48: extreme
    digits against all-ones and high-bit key words."""
    S, T = 2 * keyswitch.STRETCH + 48, 5
    d = torch.full((13, S), digit, dtype=torch.int8, device="cuda")
    d[1::2, ::5] = 0
    k = torch.full((S, T), -1, dtype=torch.int64, device="cuda")
    k[:, 1] = -(1 << 63)
    k[::3, 2] = 0x7F00FF00FF00FF00
    limbs = keyswitch.ksk_limbs(k)
    got = keyswitch.keyswitch_mac(d, limbs)
    assert torch.equal(got, keyswitch.keyswitch_mac_plain(d, limbs))
    assert torch.equal(got[0], (d[0].to(torch.int64)[:, None] * k).sum(0))


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


# --- N = 65536 at the decision tree's gadget: the cluster of 16, two blocks an SM --

TREE_ROWS = 200        # 1,200 digit rows: more than one wave of resident clusters
# A CMux step's coefficient error (rms, torus units) that the cluster of 8
# read at the decision tree's set, 12 rows of the `gen` fixture's seed, on an
# H100 (`cmux_accuracy.step_errors`); the cluster of 16 must not read more.
TREE_STEP_RMS_CLUSTER_OF_8 = 6.480667678175201e-11


def tree_set():
    from repro_torch.core.params import PAPER_PARAMS
    return PAPER_PARAMS["decision_tree"]


@pytest.mark.parametrize("with_shifts", [True, False])
def test_forward_digits_at_the_tree_set(gen, with_shifts):
    p = tree_set()
    K, N = p.k + 1, p.N
    acc = torus.random_torus(gen, (TREE_ROWS, K, N), device="cuda")
    shifts = (torch.randint(0, 2 * N, (TREE_ROWS,), generator=gen, device="cuda")
              if with_shifts else None)
    got = fourstep_fft.fft_forward_digits(acc, shifts, p.pbs_base_log, p.pbs_level)
    want = fourstep_fft.fft_forward_digits_plain(acc, shifts, p.pbs_base_log, p.pbs_level)
    assert got.shape == (TREE_ROWS, 2, K * p.pbs_level, N // 2)
    assert close(got, want, 1e-12)


@pytest.mark.parametrize("with_acc", [True, False])
def test_inverse_torus_at_the_tree_set(gen, with_acc):
    p = tree_set()
    K, N = p.k + 1, p.N
    planes = torch.randn((TREE_ROWS, 2, K, N // 2), generator=gen, device="cuda",
                         dtype=torch.float64) * 2.0 ** 60
    acc = torus.random_torus(gen, (TREE_ROWS, K, N), device="cuda") if with_acc else None
    got = fourstep_fft.fft_inverse_torus(planes, acc)
    want = fourstep_fft.fft_inverse_torus_plain(planes, acc)
    scale = fourstep_fft.fft_inverse_plain(
        planes.transpose(1, 2).reshape(TREE_ROWS * K, 2, N // 2)).abs().max().item()
    assert (got - want).abs().max().item() <= 1e-12 * scale + 1


def test_fft_residency_at_the_tree_set(gen):
    """Both CMux-step FFTs at N = 65536 hold two blocks on an SM."""
    res = fourstep_fft.residency(65536)
    print(f"residency at N = 65536: {res}")
    for name in ("fft_forward_digits", "fft_inverse_torus"):
        assert res[name]["blocks_per_sm"] >= 2 and res[name]["clusters"] >= 1, res


def test_cmux_step_error_at_the_tree_set(gen):
    from repro_torch.kernels.cmux_accuracy import step_errors
    e = step_errors(tree_set(), 12, gen)
    print(f"CMux step error at the tree set: {e}")
    assert e["kernels"]["rms"] <= TREE_STEP_RMS_CLUSTER_OF_8


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


@pytest.mark.parametrize("F", [1000, 999])
@pytest.mark.parametrize("B", ROWS)
@pytest.mark.parametrize("J,K", [(1, 1), (2, 1), (3, 1), (2, 2), (4, 2), (6, 2),
                                 (3, 3), (6, 3), (9, 3)])
def test_external_product_mac(gen, J, K, B, F):
    """Every (J, K) case the kernel builds, at every row count of the
    contract, with an even and an odd F."""
    dig = torch.randn((B, 2, J, F), generator=gen, device="cuda", dtype=torch.float64)
    bsk = torch.randn((2, J, K, F), generator=gen, device="cuda", dtype=torch.float64)
    got = external_product.external_product_mac(dig, bsk)
    assert close(got, external_product.external_product_mac_plain(dig, bsk), 1e-9)


def test_external_product_mac_refuses_unbuilt_shape(gen):
    dig = torch.zeros((1, 2, 5, 64), device="cuda", dtype=torch.float64)
    bsk = torch.zeros((2, 5, 2, 64), device="cuda", dtype=torch.float64)
    with pytest.raises(RuntimeError, match="external_product_mac launch failed"):
        external_product.external_product_mac(dig, bsk)


# --- kernels.ops: the reference's f32 planes and int32 keyswitch digits --------

@pytest.mark.parametrize("N", [256, 512, 2048, 8192, 65536])
@pytest.mark.parametrize("B", [1, 3])
def test_f32_fft_against_plain(gen, N, B):
    """The f32 instantiations within 2e-5 of the spectrum scale of the f64
    transform (tests/test_kernels.py's gate) and of the complex64 plain
    version; the round trip within the reference's 0.25 sqrt(N) / 8."""
    x = torch.randint(-(1 << 10), 1 << 10, (B, N), generator=gen,
                      device="cuda").to(torch.float32)
    reset_launch_counts()
    spec = ops.negacyclic_fft(x)
    back = ops.negacyclic_ifft(spec)
    assert spec.dtype == back.dtype == torch.float32
    assert launch_counts()["fft_forward"] == 1 and launch_counts()["fft_inverse"] == 1
    want = fourstep_fft.fft_forward_plain(x.double())
    scale = want.abs().max().item() + 1.0
    assert (spec.double() - want).abs().max().item() <= 2e-5 * scale
    plain = fourstep_fft.fft_forward_plain(x, torch.float32)
    assert (spec - plain).abs().max().item() <= 2e-5 * scale
    assert (back - fourstep_fft.fft_inverse_plain(spec, torch.float32)).abs().max().item() \
        <= 2e-5 * x.abs().max().item()
    assert (back - x).abs().max().item() <= 0.25 * N ** 0.5 / 8


@pytest.mark.parametrize("B,J,K,F", [(1, 2, 2, 256), (12, 4, 2, 1024), (12, 6, 3, 2048),
                                     (48, 4, 2, 16384), (1, 4, 2, 512), (12, 4, 2, 512)])
def test_f32_mac_against_plain(gen, B, J, K, F):
    """The f32 MAC within the reference's 1e-2 absolute (1e-4 relative) of
    the f64 product and of the complex64 einsum."""
    dig = torch.randn((B, 2, J, F), generator=gen, device="cuda") * 100
    bsk = torch.randn((2, J, K, F), generator=gen, device="cuda")
    reset_launch_counts()
    got = ops.bru_mac(dig, bsk)
    assert got.dtype == torch.float32 and launch_counts()["external_product_mac"] == 1
    for want in (external_product.external_product_mac_plain(dig, bsk, torch.float32),
                 external_product.external_product_mac_plain(dig.double(), bsk.double())):
        assert torch.allclose(got.double(), want.double(), rtol=1e-4, atol=1e-2)


@pytest.mark.parametrize("B,S,T", [(1, 128, 65), (4, 1024, 513), (2, 4096, 257)])
def test_int32_keyswitch_bit_exact(gen, B, S, T):
    d = torch.randint(-(1 << 31), (1 << 31) - 1, (B, S), generator=gen,
                      device="cuda").to(torch.int32)
    k = torch.randint(-(1 << 62), 1 << 62, (S, T), generator=gen, device="cuda") * 3
    reset_launch_counts()
    got = ops.lpu_keyswitch_mac(d, k)
    assert launch_counts()["keyswitch_mac"] == 1
    assert torch.equal(got, keyswitch.keyswitch_mac_int32_plain(d, k))


def test_int32_keyswitch_extreme_digits(gen):
    d = torch.tensor([[-(1 << 31), (1 << 31) - 1, -1, 1, 0, 7, -7, 12345],
                      [2139062143, 2139062144, -2139062144, -2139062145,
                       (1 << 31) - 1, -(1 << 31), 255, -256]],
                     dtype=torch.int32, device="cuda")
    k = torch.randint(-(1 << 62), 1 << 62, (8, 33), generator=gen, device="cuda") * 3
    got = ops.lpu_keyswitch_mac(d, k, block_s=8)
    assert torch.equal(got, keyswitch.keyswitch_mac_int32_plain(d, k))
    assert torch.equal(got, (d.to(torch.int64)[:, :, None] * k[None]).sum(1))


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


# --- the blind rotation replayed as a captured CUDA graph ------------------------

PER_ROUND = ("keyswitch_mac", "fft_forward", "fft_inverse", "external_product_mac")


def graph_round(ctx, gen, B):
    """B fresh ciphertexts under B random tables: (cts, LUT polys, the
    tables' values)."""
    from repro_torch.core import glwe
    mod = ctx.params.plaintext_modulus
    msgs = torch.randint(0, mod, (B,), generator=gen, device="cuda")
    tables = torch.randint(0, mod, (B, mod), generator=gen, device="cuda")
    polys = glwe.make_lut_polys_cached(tables.cpu(), ctx.params, device="cuda")
    return ctx.encrypt(gen, msgs), polys, tables[torch.arange(B, device="cuda"), msgs].tolist()


def eager_pbs(pack, cts, polys):
    """The PBS by eager launches, outside the pack's graphs."""
    from repro_torch.kernels import fused_pbs
    return fused_pbs.pbs_batch_fused(cts, polys, pack.bsk_planes, pack.ksk_limbs, pack.params)


@pytest.mark.parametrize("B", [1, 16, 288])
@pytest.mark.parametrize("p", [TEST_PARAMS, TEST_PARAMS_K2], ids=lambda p: p.name)
def test_graph_replay_is_bit_identical_to_eager_launches(gen, p, B):
    """A row count's first round runs eagerly, its second captures and
    replays, later ones replay; each gives the eager launches' output bit
    for bit, `lut_batch_small` replays the same graph, and the launch
    counts are rounds x (1, n, n, n) across all of them."""
    from repro_torch.obs import Telemetry
    ctx = TFHEContext.create(gen, p)
    tel = Telemetry(trace=True)
    engine = TaurusEngine.from_context(ctx, telemetry=tel)
    cts, polys, want = graph_round(ctx, gen, B)
    eager = eager_pbs(engine.fused_pack, cts, polys)
    reset_launch_counts()
    outs = [engine.lut_batch(cts, polys) for _ in range(3)]
    outs.append(engine.lut_batch_small(engine.keyswitch(cts), polys))
    assert all(torch.equal(o, eager) for o in outs)
    assert ctx.decrypt(outs[-1]).tolist() == want
    assert launch_counts() == dict(zip(PER_ROUND, (4, 4 * p.n, 4 * p.n, 4 * p.n)))
    assert engine.fused_pack.rotations() == {"eager": 1, "capture": 1, "replay": 2}
    spans = [s for s in tel.recorder.spans() if s.name in ("lut_batch", "lut_batch_small")]
    assert [s.args["graph"] for s in spans] == ["eager", "capture", "replay", "replay"]
    snap = tel.snapshot()["counters"]
    assert (snap["engine.graph_eager"], snap["engine.graph_captures"],
            snap["engine.graph_replays"]) == (1, 1, 2)


def test_graph_replays_leave_earlier_outputs_alone(gen):
    """Two inputs replayed in turn give two right outputs, and a tensor
    returned before a replay is unchanged after it."""
    ctx = TFHEContext.create(gen, TEST_PARAMS)
    engine = TaurusEngine.from_context(ctx)
    x, y = graph_round(ctx, gen, 16), graph_round(ctx, gen, 16)
    want_x, want_y = (eager_pbs(engine.fused_pack, c, q) for c, q, _ in (x, y))
    engine.lut_batch(*x[:2])
    engine.lut_batch(*x[:2])                            # captured
    out_x = engine.lut_batch(*x[:2])
    kept = out_x.clone()
    out_y = engine.lut_batch(*y[:2])
    assert torch.equal(out_x, kept) and torch.equal(out_x, want_x)
    assert torch.equal(out_y, want_y) and not torch.equal(want_x, want_y)
    assert ctx.decrypt(out_x).tolist() == x[2] and ctx.decrypt(out_y).tolist() == y[2]


@pytest.mark.parametrize("own_stream", [False, True], ids=["one stream", "two streams"])
def test_two_threads_replay_one_pack_at_once(gen, own_stream):
    """Two threads run rounds of their own inputs on one pack at once, on
    the default stream (one graph, taken in turn) or the second on a
    stream of its own (a graph each): every output is right."""
    import threading
    ctx = TFHEContext.create(gen, TEST_PARAMS)
    engine = TaurusEngine.from_context(ctx)
    jobs = [graph_round(ctx, gen, 32) for _ in range(2)]
    wants = [eager_pbs(engine.fused_pack, c, q) for c, q, _ in jobs]
    torch.cuda.synchronize()
    start = threading.Barrier(2)
    results = [[], []]
    errors = []

    def work(i):
        try:
            stream = torch.cuda.Stream() if own_stream and i else torch.cuda.current_stream()
            with torch.cuda.stream(stream):
                start.wait(timeout=30)
                for _ in range(6):
                    out = engine.lut_batch(*jobs[i][:2])
                    stream.synchronize()
                    results[i].append(out)
        except Exception as e:          # re-raised on the test's thread below
            errors.append(e)

    threads = [threading.Thread(target=work, args=(i,)) for i in range(2)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=120)
    assert not any(th.is_alive() for th in threads) and not errors, errors
    for outs, want, job in zip(results, wants, jobs):
        assert len(outs) == 6 and all(torch.equal(o, want) for o in outs)
        assert ctx.decrypt(outs[-1]).tolist() == job[2]
    assert len(engine.fused_pack._graphs.graphs) == (2 if own_stream else 1)


def test_capture_while_another_thread_copies_to_the_host(gen):
    """A capture (thread-local mode, on a side stream) succeeds while
    another thread keeps running torch ops on the card and copying their
    results to the host; both threads' results are right."""
    import threading
    ctx = TFHEContext.create(gen, TEST_PARAMS)
    engine = TaurusEngine.from_context(ctx)
    cts, polys, want = graph_round(ctx, gen, 64)
    eager = eager_pbs(engine.fused_pack, cts, polys)
    stop = threading.Event()
    sums, errors = [], []

    def busy():
        try:
            x = torch.arange(1 << 16, dtype=torch.float64, device="cuda")
            while not stop.is_set():
                sums.append((x * 2 + 1).sum().cpu().item())
        except Exception as e:          # re-raised on the test's thread below
            errors.append(e)

    other = threading.Thread(target=busy)
    other.start()
    try:
        engine.lut_batch(cts, polys)
        reset_launch_counts()
        outs = [engine.lut_batch(cts, polys) for _ in range(2)]     # capture, replay
        torch.cuda.synchronize()
    finally:
        stop.set()
        other.join(timeout=60)
    assert not other.is_alive() and not errors, errors
    assert engine.fused_pack.rotations() == {"eager": 1, "capture": 1, "replay": 1}
    steps = 2 * TEST_PARAMS.n
    assert launch_counts() == dict(zip(PER_ROUND, (2, steps, steps, steps)))
    assert all(torch.equal(o, eager) for o in outs)
    assert ctx.decrypt(outs[-1]).tolist() == want
    n = 1 << 16
    assert sums and set(sums) == {float(n * (n - 1) + n)}


@pytest.fixture(scope="module")
def int_ctx():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    gen = torch.Generator(device="cuda").manual_seed(11)
    return IntegerContext.create(TFHEContext.create(gen, TEST_PARAMS_4BIT)), gen


RADIX_CASES = [("add", "radix_add", 0xBE, 0x7C, (0xBE + 0x7C) % 256),
               ("mul", "radix_mul", 0xB7, 0x59, (0xB7 * 0x59) % 256),
               ("compare", "radix_cmp", 0x34, 0x9A, 1),
               ("relu_clamp", "radix_relu", -5, None, 0),
               ("relu_clamp", "radix_relu", 0x5A, None, 0x5A)]


@pytest.mark.parametrize("op,ir_op,a,b,want", RADIX_CASES)
def test_radix_integers_on_the_card(int_ctx, op, ir_op, a, b, want):
    """8-bit radix integers (4 two-bit digits) with the port's own keys on
    the card, through the fused engine: each op decrypts to the oracle,
    runs as many rounds as its plan, and every round launches the four
    kernels (1, n, n, n) times."""
    ic, gen = int_ctx
    assert ic.engine.kernel_backend == "fused" and ic.engine.device.type == "cuda"
    ca = ic.encrypt(gen, a, 8)
    cb = None if b is None else ic.encrypt(gen, b, 8)
    ic.reset_stats()
    reset_launch_counts()
    out = ic.relu_clamp(ca) if b is None else getattr(ic, op)(ca, cb)
    got = int(ic.ctx.decrypt(out)) if op == "compare" else ic.decrypt(out)
    assert got == want
    rounds = ic.stats["lut_batches"]
    spec = ic.spec(8)
    assert rounds == len(radix_round_plan(ir_op, spec.n_digits, spec.msg_bits))
    n = ic.params.n
    assert launch_counts() == {"keyswitch_mac": rounds, "fft_forward": rounds * n,
                               "fft_inverse": rounds * n,
                               "external_product_mac": rounds * n}


@pytest.fixture(scope="module")
def ctx_6bit():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    gen = torch.Generator(device="cuda").manual_seed(13)
    return TFHEContext.create(gen, TEST_PARAMS_6BIT), gen


@pytest.mark.parametrize("backend", ["eager", "local"])
def test_narrow_gpt2_block_on_the_card(ctx_6bit, backend):
    """The narrow-LUT GPT-2 block (11 lut nodes, 48 PBS of 6-bit tables)
    on the port's own keys through the fused engine decrypts to
    `interpret`, and every kernel launched."""
    ctx, gen = ctx_6bit
    g, _ = lower.lower_gpt2_block(4, QuantSpec(3, 0.25, 4), 6, seed=1)
    q = np.random.default_rng(3).integers(0, 8, (4,))
    sess = Session(ctx, backend=backend)
    prog = sess.compile(g)
    enc = sess.encrypt_inputs(gen, [q], prog)
    reset_launch_counts()
    got = sess.decrypt_outputs(prog, sess.run(prog, enc))[0]
    np.testing.assert_array_equal(got, interpret(g, [q], 6)[g.outputs[0]])
    assert min(launch_counts().values()) > 0


@pytest.mark.parametrize("backend", ["eager", "local"])
def test_quantize_to_radix_mlp_on_the_card(int_ctx, backend):
    """quantize_to_radix -> the 8-bit radix MLP -> dequantize_radix on the
    card: the integers equal `int_fn`, the floats are within `tol_fn` of
    the float model."""
    ic, gen = int_ctx
    rng = np.random.default_rng(0)
    w1, w2 = rng.normal(size=(2, 3)) * 0.5, rng.normal(size=(3, 2)) * 0.5
    xf = rng.uniform(-1, 1, size=(2,))
    g, meta = lower.lower_mlp_radix(w1, w2, bits=8, msg_bits=2)
    rq = quantize.calibrate_radix(xf, 8, 2, qmax=meta["input_qmax"])
    q = quantize.quantize_to_radix(xf, rq)
    sess = Session(ic.ctx, ic.engine, backend=backend)
    prog = sess.compile(g, meta["in_specs"], meta["out_specs"])
    reset_launch_counts()
    got = sess(prog, gen, q)[0]
    assert min(launch_counts().values()) > 0
    np.testing.assert_array_equal(got % 256, meta["int_fn"](q) % 256)
    yhat = quantize.dequantize_radix(
        got, quantize.RadixQuantSpec(8, 2, rq.scale * meta["out_scale_mul"]))
    assert np.all(np.abs(yhat - meta["float_fn"](xf)) <= meta["tol_fn"](rq))


# --- the serving runtime on the card ----------------------------------------------

@pytest.fixture(scope="module")
def serve_jobs(ctx_6bit):
    """Two programs on the 6-bit keys, encrypted once, with their eager
    decrypts: the narrow GPT-2 block and the quickstart program on 16-bit
    integers of 2-bit digits."""
    ctx, gen = ctx_6bit
    sess = Session(ctx, backend="eager")
    g, _ = lower.lower_gpt2_block(4, QuantSpec(3, 0.25, 4), 6, seed=1)
    narrow = sess.compile(g)
    quick = sess.trace(lambda a, b: ((a * b).relu(), a < b),
                       IntSpec(16, msg_bits=2), IntSpec(16, msg_bits=2))
    q = np.random.default_rng(3).integers(0, 8, (4,))
    jobs = [("narrow", narrow, sess.encrypt_inputs(gen, [q], narrow)),
            ("quick", quick, sess.encrypt_inputs(gen, [0x1234, 0x0567], quick))]
    eager = [plain(sess.decrypt_outputs(p, sess.run(p, enc))) for _, p, enc in jobs]
    prod = (0x1234 * 0x0567) % (1 << 16)
    assert eager[0] == plain([interpret(g, [q], 6)[g.outputs[0]]])
    assert eager[1] == [prod if prod < 1 << 15 else 0, [0]]
    return sess, jobs, eager


def plain(vals) -> list:
    return [np.asarray(v).tolist() for v in vals]


def serve_on_card(ctx, jobs, **kw):
    """One paused-then-resumed wave through Session(backend="serve");
    returns the session, the decrypts and the wave's launch counts."""
    sess = Session(ctx, backend="serve", max_inflight=len(jobs), start_paused=True, **kw)
    handles = [sess.submit(p, enc, client_id=c) for c, p, enc in jobs]
    torch.cuda.synchronize()
    reset_launch_counts()
    sess.backend.runtime.resume()
    outs = [h.wait(timeout=600) for h in handles]
    torch.cuda.synchronize()
    counts = launch_counts()
    got = [plain(sess.decrypt_outputs(p, [o[i] for i in p.graph.outputs]))
           for (_, p, _), o in zip(jobs, outs)]
    sess.close()
    return sess, got, counts


def test_served_wave_on_the_card(ctx_6bit, serve_jobs):
    """Both programs served concurrently on the card decrypt as eager
    did; every fused round is one keyswitch launch and n of each FFT and
    the MAC."""
    ctx, _ = ctx_6bit
    _, jobs, eager = serve_jobs
    sess, got, counts = serve_on_card(ctx, jobs)
    assert got == eager
    st = sess.backend.scheduler.stats
    n, rounds = ctx.params.n, st["fused_rounds"]
    assert 0 < rounds < st["logical_luts"] and st["padded_luts"] >= st["dispatched_luts"]
    assert counts == {"keyswitch_mac": rounds, "fft_forward": rounds * n,
                      "fft_inverse": rounds * n, "external_product_mac": rounds * n}


def test_fault_retry_on_the_card(ctx_6bit, serve_jobs):
    """A fused round that raises on the card reaches every request in it;
    each retries through the fault layer and still decrypts as eager."""
    from repro_torch.runtime import FaultConfig
    ctx, _ = ctx_6bit
    _, jobs, eager = serve_jobs
    sess = Session(ctx, backend="serve", max_inflight=2, start_paused=True,
                   fault=FaultConfig(max_retries=1))
    engine, calls = sess.engine, {"n": 0}

    def poison(real):
        def run(cts, polys):
            calls["n"] += 1
            if calls["n"] == 2:
                raise RuntimeError("poisoned round")
            return real(cts, polys)
        return run

    engine.lut_batch = poison(engine.lut_batch)
    engine.lut_batch_small = poison(engine.lut_batch_small)
    handles = [sess.submit(p, enc, client_id=c) for c, p, enc in jobs]
    sess.backend.runtime.resume()
    outs = [h.wait(timeout=600) for h in handles]
    assert [h.retries for h in handles] == [1, 1]
    got = [plain(sess.decrypt_outputs(p, [o[i] for i in p.graph.outputs]))
           for (_, p, _), o in zip(jobs, outs)]
    assert got == eager
    sess.close()


def test_two_shards_share_one_pack_on_the_card(ctx_6bit, serve_jobs):
    """shards=2 on one card: one request on each shard, decrypts equal to
    shards=1, and both shards' engines read one resident pack."""
    ctx, _ = ctx_6bit
    _, jobs, eager = serve_jobs
    sess, got, counts = serve_on_card(ctx, jobs, shards=2)
    shards = sess.backend.runtime.shards
    assert got == eager
    assert shards[0].engine is not shards[1].engine
    assert shards[0].engine.fused_pack is shards[1].engine.fused_pack
    c = sess.backend.runtime.metrics()["counters"]
    per_shard = [c[f"serve.shard.{i}.fused_rounds"] for i in (0, 1)]
    assert min(per_shard) > 0 and sum(per_shard) == c["sched.fused_rounds"]
    assert counts["keyswitch_mac"] == c["sched.fused_rounds"]


def test_traced_wave_times_each_fused_round_on_the_card(ctx_6bit, serve_jobs):
    """A traced wave, the engine's telemetry handed over by the runtime:
    every fused round gets its device time from two CUDA events
    (`device_ms` > 0; `device_gap_ms` >= 0 from the second round on);
    the device lane's intervals are disjoint and lie in the wave's host
    wall; from the first round's start to the last round's end the
    device's time in and between rounds sums to the host's within 5%."""
    import time
    from repro_torch.obs import Telemetry, validate_chrome_trace
    ctx, _ = ctx_6bit
    _, jobs, eager = serve_jobs
    tel = Telemetry(trace=True)
    sess = Session(ctx, backend="serve", max_inflight=len(jobs), start_paused=True,
                   telemetry=tel)
    handles = [sess.submit(p, enc, client_id=c) for c, p, enc in jobs]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sess.backend.runtime.resume()
    outs = [h.wait(timeout=600) for h in handles]
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    got = [plain(sess.decrypt_outputs(p, [o[i] for i in p.graph.outputs]))
           for (_, p, _), o in zip(jobs, outs)]
    sess.close()
    assert got == eager
    spans = tel.recorder.spans()
    rounds = [s for s in spans if s.name == "fused_round"]
    lane = [s for s in spans if s.name == "device_round"]
    assert len(rounds) == len(lane) > 1
    assert all(r.args["device_ms"] > 0 for r in rounds)
    assert "device_gap_ms" not in rounds[0].args
    assert all(r.args["device_gap_ms"] >= 0 for r in rounds[1:])
    assert all(a.ts + a.dur <= b.ts for a, b in zip(lane, lane[1:]))
    assert t0 <= lane[0].ts and lane[-1].ts + lane[-1].dur <= t1
    device_s = (sum(r.args["device_ms"] for r in rounds)
                + sum(r.args["device_gap_ms"] for r in rounds[1:])) / 1e3
    host_s = rounds[-1].ts + rounds[-1].dur - rounds[0].ts
    print(f"traced wave on {torch.cuda.get_device_name()}: {len(rounds)} fused rounds, "
          f"device in and between rounds {device_s:.6f} s, host first round's start to "
          f"last round's end {host_s:.6f} s, wave {t1 - t0:.6f} s")
    assert abs(device_s - host_s) <= 0.05 * host_s
    assert validate_chrome_trace(tel.chrome_trace()) > len(spans)


def test_engine_spans_enclose_their_launches_on_the_profilers_clock(ctx_6bit):
    """A profiled round: its `lut_batch` span, put on torch.profiler's
    clock by `to_profiler_us`, encloses every kernel launch the profiler
    saw the round make, within 0.2 ms."""
    import json
    import os
    import tempfile
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core import glwe
    from repro_torch.obs import Telemetry
    ctx, gen = ctx_6bit
    p = ctx.params
    rows = 12
    cts = ctx.encrypt(gen, torch.arange(rows, device="cuda") % p.plaintext_modulus)
    polys = glwe.make_lut_polys_cached(
        torch.tensor([list(range(p.plaintext_modulus))] * rows), p, device="cuda")
    tel = Telemetry(trace=True)
    engine = TaurusEngine.from_context(ctx, telemetry=tel)
    engine.lut_batch(cts, polys)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        engine.lut_batch(cts, polys)
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "round.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            obj = json.load(f)
    base_us = obj.get("baseTimeNanoseconds", 0) / 1e3
    launches = [(e["ts"] + base_us, e["ts"] + base_us + e["dur"])
                for e in obj["traceEvents"]
                if str(e.get("cat", "")).startswith("cuda_") and "Launch" in e["name"]
                and "dur" in e]
    span = [s for s in tel.recorder.spans() if s.name == "lut_batch"][-1]
    lo = tel.recorder.to_profiler_us(span.ts)
    hi = tel.recorder.to_profiler_us(span.ts + span.dur)
    after_start = min(a for a, _ in launches) - lo
    before_end = hi - max(b for _, b in launches)
    print(f"profiled round on {torch.cuda.get_device_name()}: {len(launches)} launches; "
          f"the first starts {after_start:.1f} us after the span's start, the last ends "
          f"{before_end:.1f} us before its end (span {span.dur * 1e6:.1f} us)")
    assert len(launches) >= 3 * p.n
    assert after_start >= -200 and before_end >= -200


# --- the XPU baseline and the traffic simulator on the card ---------------------

@pytest.mark.parametrize("p", [TEST_PARAMS, TEST_PARAMS_K2], ids=lambda p: p.name)
def test_lut_batch_xpu_on_the_card(gen, p):
    """The per-ciphertext loop on the fused backend: one keyswitch and n of
    each FFT and the MAC per ciphertext, decrypting as the batched round
    and as the reference backend's plain loop."""
    from repro_torch.core import glwe
    ctx = TFHEContext.create(gen, p)
    mod = p.plaintext_modulus
    msgs = torch.arange(5, device="cuda") % mod
    cts = ctx.encrypt(gen, msgs)
    table = [(3 * v + 1) % mod for v in range(mod)]
    polys = glwe.make_lut_polys_cached(torch.tensor([table] * 5), p, device="cuda")
    engine = TaurusEngine.from_context(ctx)
    reset_launch_counts()
    out = engine.lut_batch_xpu(cts, polys)
    assert launch_counts() == {"keyswitch_mac": 5, "fft_forward": 5 * p.n,
                               "fft_inverse": 5 * p.n, "external_product_mac": 5 * p.n}
    want = [table[m] for m in msgs.tolist()]
    assert ctx.decrypt(out).tolist() == want
    assert ctx.decrypt(engine.lut_batch(cts, polys)).tolist() == want
    ref = TaurusEngine.from_context(ctx, kernel_backend="reference")
    assert ctx.decrypt(ref.lut_batch_xpu(cts, polys)).tolist() == want


def test_run_scenario_on_the_card(int_ctx):
    """A 2-second open-loop scenario (radix add and mul on 8-bit integers
    of 2-bit digits, const-op analytics) through `repro_torch.sim` on the
    card's `ServeRuntime`: every request DONE, every payload decrypting to
    its oracle, and one keyswitch and n of each FFT and the MAC per fused
    round the engine ran."""
    from repro_torch import sim
    from repro_torch.obs import Telemetry
    ic, _ = int_ctx
    mix = sim.WorkloadMix.of({"radix_add": 2.0, "radix_mul": 1.0, "analytics_const": 1.0},
                             bits=8, msg_bits=2)
    sc = sim.Scenario("card", sim.Poisson(3.0), mix, duration_s=2.0, deadline_s=600.0,
                      population=3, seed=2)
    tel = ic.engine.telemetry = Telemetry()
    try:
        reset_launch_counts()
        run = sim.run_scenario(sc, ic.ctx, ic.engine, max_inflight=3, validate=True)
        torch.cuda.synchronize()
        counts = launch_counts()
    finally:
        ic.engine.telemetry = None
    plan = sim.arrival_plan(sc.arrival, sc.population, sc.duration_s, sc.seed)
    o = run.report["overall"]
    assert o["requests"] == o["done"] == len(run.records) == len(plan) > 0
    assert all(r.record.ok_payload for r in run.records)
    rounds, n = tel.snapshot()["counters"]["engine.lut_batches"], ic.params.n
    assert rounds > 0 and counts == {"keyswitch_mac": rounds, "fft_forward": rounds * n,
                                     "fft_inverse": rounds * n,
                                     "external_product_mac": rounds * n}


@pytest.mark.parametrize("arch", list(configs.ARCH_IDS))
def test_reduced_lm_card_against_cpu(gen, arch):
    """A reduced config's forward hidden states and 16 decode steps'
    logits on the card equal the CPU's on the same weights."""
    cfg = reduced_config(arch)
    g = torch.Generator().manual_seed(11)
    cpu = build(cfg, "cpu").init(g)
    card = build(cfg)
    card.load_state_dict(cpu.state_dict())
    toks = torch.randint(0, cfg.vocab_size, (2, 16), generator=g, dtype=torch.int32)
    fe = (torch.randn((2, cfg.frontend_len, cfg.frontend_dim), generator=g)
          if cfg.frontend != "none" else None)
    with torch.no_grad():
        want, _ = cpu(toks, fe)
        got, _ = card(toks.cuda(), None if fe is None else fe.cuda())
    assert torch.allclose(got.cpu(), want, rtol=1e-4, atol=1e-4)
    c_cpu, c_card = cpu.init_cache(2, 16), card.init_cache(2, 16)
    for i in range(16):
        pos = torch.full((2, 1), i, dtype=torch.int32)
        want, c_cpu = cpu.decode_step(c_cpu, toks[:, i:i + 1], pos)
        got, c_card = card.decode_step(c_card, toks[:, i:i + 1].cuda(), pos.cuda())
        assert torch.allclose(got.cpu(), want, rtol=1e-4, atol=1e-4)


def test_full_width_qwen3_decode_step_bf16(gen):
    """One decode step of qwen3-0.6b at full width (28 layers, d 1024,
    vocab 151,936, bf16) from the port's seeded init on the card."""
    cfg = configs.get("qwen3-0.6b")
    model = build(cfg).init(gen)
    assert model.embed.dtype == torch.bfloat16 and model.embed.is_cuda
    cache = model.init_cache(4, 8)
    toks = torch.randint(0, cfg.vocab_size, (4, 1), generator=gen, device="cuda",
                         dtype=torch.int32)
    pos = torch.zeros((4, 1), dtype=torch.int32, device="cuda")
    logits, cache = model.decode_step(cache, toks, pos)
    assert logits.shape == (4, cfg.vocab_size) and logits.dtype == torch.float32
    assert torch.isfinite(logits).all()
    assert cache[0]["index"] == 1 and (cache[0]["pos"][:, 0] == 0).all()
    assert (cache[0]["pos"][:, 1:] == POS_SENTINEL).all()
    want = make_prefill_step(cfg)(model, {"tokens": toks})
    assert (logits - want).abs().max() <= 0.125 * want.abs().max()


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "qwen2-moe-a2.7b", "mamba2-130m"])
def test_reduced_train_step_card_against_cpu(gen, arch):
    """One train step of a reduced config (f32) on the card and on the CPU
    from the same weights and batch."""
    cfg = reduced_config(arch)
    cpu = build(cfg, "cpu").init(torch.Generator().manual_seed(5))
    card = build(cfg)
    card.load_state_dict(cpu.state_dict())
    batch = SyntheticLMData(DataConfig(cfg.vocab_size, 32, 2)).batch(0, "cpu")
    out = {}
    for name, model in (("cpu", cpu), ("card", card)):
        opt = AdamW(lr=cosine_schedule(3e-3, 0, 2))
        state = opt.init(dict(model.named_parameters()))
        state, metrics = make_train_step(cfg, opt, loss_chunk=16)(
            model, state, {k: v.to(model.device) for k, v in batch.items()}, 0)
        out[name] = metrics["loss"].item()
        assert state["m"]["embed"].device == model.device
    assert abs(out["card"] - out["cpu"]) <= 1e-4 * abs(out["cpu"])
    err = torch.cat([(b.cpu() - a).abs().flatten()
                     for a, b in zip(cpu.state_dict().values(), card.state_dict().values())])
    assert (err > 1e-4).sum().item() <= 1e-4 * err.numel() and err.max().item() <= 2 * 3e-3


def test_checkpoint_round_trip_of_bf16_card_tensors(gen, tmp_path):
    w = torch.randn((64, 48), generator=gen, device="cuda").to(torch.bfloat16)
    m = torch.randn((64, 48), generator=gen, device="cuda")
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(3, {"model": {"w": w}, "m": {"w": m}})
    like = {"model": {"w": torch.zeros_like(w)}, "m": {"w": torch.zeros_like(m)}}
    got, step = mgr.restore(like)
    assert step == 3 and got["model"]["w"].is_cuda and got["model"]["w"].dtype == torch.bfloat16
    assert torch.equal(got["model"]["w"].view(torch.int16), w.view(torch.int16))
    assert torch.equal(got["m"]["w"].view(torch.int32), m.view(torch.int32))


def test_int8_compressor_card_against_cpu(gen):
    comp = Int8Compressor()
    g = {"a": torch.randn((512, 256), generator=gen, device="cuda") * 1e-3,
         "b": torch.randn((256,), generator=gen, device="cuda")}
    ef = {k: torch.randn(v.shape, generator=gen, device="cuda") * 1e-5 for k, v in g.items()}
    out, new_ef = comp.roundtrip(g, ef)
    out_cpu, ef_cpu = comp.roundtrip({k: v.cpu() for k, v in g.items()},
                                     {k: v.cpu() for k, v in ef.items()})
    for k in g:
        q, scale, _ = comp.compress(g[k], ef[k])
        q_cpu, scale_cpu, _ = comp.compress(g[k].cpu(), ef[k].cpu())
        assert q.is_cuda and q.dtype == torch.int8
        assert abs(scale.item() - scale_cpu.item()) <= 1e-6 * scale_cpu.item()
        r = (g[k] + ef[k]).cpu().double() / scale_cpu.item()
        away = ((r - r.floor()).sub(0.5).abs() >= 2e-4)
        diff = (q.cpu().int() - q_cpu.int()).abs()
        assert (diff[away] == 0).all() and (diff <= 1).all()
        err = (new_ef[k].cpu() - ef_cpu[k]).abs()
        assert (err[away] <= 2e-4 * scale_cpu.item()).all()
        assert torch.isfinite(new_ef[k]).all()


def test_resolve_device_refuses_a_silent_cpu_run(gen, monkeypatch):
    """With a card, the entry points default to it; told there is none,
    they raise instead of running on the CPU."""
    assert resolve_device().type == "cuda"
    assert SyntheticLMData(DataConfig(64, 8, 2)).batch(0)["tokens"].is_cuda
    losses, _ = train("qwen3-0.6b", steps=2, batch=2, seq=32, log_every=100)
    assert len(losses) == 2 and all(np.isfinite(losses))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train("qwen3-0.6b", steps=1, batch=2, seq=32)



# --- the multi-device paths on one card ------------------------------------------

def test_cluster_mesh_on_the_card(gen):
    """Four clusters on one card (reference backend): n_clusters 4, batch 48;
    8 rows of (3m + 2) mod p, and 6 rows padded by 2, decrypt to the table,
    equal the one-device reference engine on each cluster's 2 rows bit for
    bit and decrypt as its whole round does; the keys are held once."""
    from repro_torch.launch.mesh import shard_mesh
    from repro_torch.obs import Telemetry
    ctx = TFHEContext.create(gen, TEST_PARAMS)
    eng = TaurusEngine.from_context(ctx, mesh=shard_mesh([torch.device("cuda", 0)] * 4))
    one = TaurusEngine.from_context(ctx, kernel_backend="reference")
    assert eng.n_clusters == 4 and eng.batch_size == 48 and len(eng._keys) == 1
    mod = TEST_PARAMS.plaintext_modulus
    table = [(3 * m + 2) % mod for m in range(mod)]
    for B in (8, 6):
        msgs = torch.arange(B, device="cuda") % mod
        cts = ctx.encrypt(gen, msgs)
        eng.telemetry = tel = Telemetry()
        reset_launch_counts()
        out = eng.lut_batch_tables(cts, table)
        eng.telemetry = None
        assert not any(launch_counts().values())
        assert ctx.decrypt(out).tolist() == [table[m] for m in msgs.tolist()]
        padded = torch.cat([cts, cts[:8 - B]])
        by_cluster = torch.cat([one.lut_batch_tables(padded[i:i + 2], table)
                                for i in range(0, 8, 2)])
        assert torch.equal(out, by_cluster[:B])
        assert torch.equal(ctx.decrypt(one.lut_batch_tables(cts, table)), ctx.decrypt(out))
        c = tel.snapshot()["counters"]
        assert c["engine.pbs_rows"] == 8 and c["engine.pbs_rows_padded"] == 8 - B


def test_fused_round_past_the_grid_rows(gen):
    """16,400 rows at TEST_PARAMS: 65,600 FFT digit rows, past the 65,535 a
    launch puts on grid y, so each forward transform runs two launches;
    every row decrypts to its table, and the first 64 decrypt as the
    reference engine's do."""
    from repro_torch.kernels.fourstep_fft import row_slices
    p = TEST_PARAMS
    B, J = 16400, (p.k + 1) * p.pbs_level
    assert B * J == 65600 and len(row_slices(B, J)) == 2
    ctx = TFHEContext.create(gen, p)
    mod = p.plaintext_modulus
    msgs = torch.arange(B, device="cuda") % mod
    cts = ctx.encrypt(gen, msgs)
    tables = (torch.arange(mod)[None] + torch.arange(B)[:, None]) % mod
    reset_launch_counts()
    out = TaurusEngine.from_context(ctx).lut_batch_tables(cts, tables)
    assert launch_counts() == {"keyswitch_mac": 1, "fft_forward": 2 * p.n,
                               "fft_inverse": p.n, "external_product_mac": p.n}
    got = ctx.decrypt(out).cpu()
    assert torch.equal(got, tables[torch.arange(B), msgs.cpu()])
    ref = TaurusEngine.from_context(ctx, kernel_backend="reference").lut_batch_tables(
        cts[:64], tables[:64])
    assert torch.equal(ctx.decrypt(ref).cpu(), got[:64])


def test_every_reduced_config_through_dtensor_at_world_size_one(gen, tmp_path):
    """One NCCL rank, every placement on a size-1 mesh dim: each reduced
    config's two train steps and a short decode through DTensor
    placements give the losses, tokens and logits of the runs without a
    process group (the same local ops; f32).  The card's PyTorch refuses
    some DTensor layouts that the CPU's accepts, so this is where those
    show."""
    import torch.distributed as dist
    tkw = dict(steps=2, batch=2, seq=32, log_every=100)
    skw = dict(batch=2, prompt_len=4, gen=4)
    plain = {}
    for arch in configs.ARCH_IDS:
        run = serve(arch, **skw)
        plain[arch] = (train(arch, **tkw)[0], run.tokens, run.logits.float().cpu())
    dist.init_process_group("nccl", store=dist.FileStore(str(tmp_path / "store"), 1),
                            rank=0, world_size=1)
    try:
        for arch in configs.ARCH_IDS:
            losses, _ = train(arch, model_parallel=1, **tkw)
            run = serve(arch, model_parallel=1, **skw)
            assert np.allclose(losses, plain[arch][0], rtol=1e-5, atol=0), arch
            assert np.array_equal(run.tokens, plain[arch][1]), arch
            assert (run.logits.float().cpu() - plain[arch][2]).abs().max().item() <= 1e-5, arch
    finally:
        dist.destroy_process_group()


# --- Taurus's 9-bit decision tree at its N = 65536, level-3 set ---------------------

@pytest.fixture(scope="module")
def dtree_ctx():
    """Keys at `PAPER_PARAMS["decision_tree"]` (n 1070, N 65536, PBS 2^11 x
    3): about 21 GB of evaluation keys with the fused pack's operands, so
    these tests come last in the file and free them at its end."""
    import gc
    from repro_torch.core.params import PAPER_PARAMS
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    gen = torch.Generator(device="cuda").manual_seed(2025)
    box = [TFHEContext.create(gen, PAPER_PARAMS["decision_tree"]), gen]
    yield box
    box.clear()
    gc.collect()
    torch.cuda.empty_cache()


def test_served_tree_at_the_decision_tree_set(dtree_ctx):
    """One 91-node, depth-18 tree request at the paper's 9-bit set served
    on the fused engine (2 rounds, the CUDA-graph replay's path) decrypts
    to the plain tree walk, as the same ciphertexts do through the plain
    `kernel_backend="reference"` engine on the same keys."""
    from repro_torch.fhe_ml import tree_reference, trees
    ctx, gen = dtree_ctx
    t = trees.random_tree(2025)
    g, meta = trees.lower_decision_tree(t, ctx.params.width)
    x = torch.randint(0, 256, (2, 16), generator=gen, device="cuda").cpu().numpy()
    onehot, cls = tree_reference.predict(t, x)
    want = [[onehot[i].tolist(), [cls[i].item()]] for i in range(2)]
    with Session(ctx, backend="serve", kernel_backend="fused", max_inflight=2) as sess:
        prog = sess.compile(g, meta["in_specs"], meta["out_specs"])
        encs = [sess.encrypt_inputs(gen, [row], prog) for row in x]
        handles = [sess.submit(prog, enc, client_id=f"c{i}") for i, enc in enumerate(encs)]
        got = [plain(sess.decrypt_outputs(prog, h.outputs())) for h in handles]
        c = sess.metrics()["counters"]
    ref_sess = Session(ctx, backend="local", kernel_backend="reference")
    ref = [plain(ref_sess.decrypt_outputs(prog, ref_sess.run(prog, encs[0])))]
    assert got == want
    assert ref == want[:1]
    assert c["sched.logical_luts"] == 2 * meta["pbs"]


def test_engine_gauges_fft_residency_at_the_decision_tree_set(dtree_ctx):
    """Building its pack, an engine with telemetry sets
    `engine.fft_clusters_resident` to the clusters of its N's FFT
    launches that fit at once."""
    from repro_torch.obs import Telemetry
    ctx, _ = dtree_ctx
    tel = Telemetry()
    TaurusEngine.from_context(ctx, telemetry=tel).fused_pack
    res = fourstep_fft.residency(ctx.params.N)
    got = tel.snapshot()["gauges"]["engine.fft_clusters_resident"]
    assert got == min(r["clusters"] for r in res.values()) >= 1


def test_graph_cache_byte_counters_at_two_row_counts(dtree_ctx, monkeypatch):
    """At the decision-tree set, a capture at 16 and at 48 rows in a cache
    of one graph: `engine.graph_bytes_captured` counts each graph's
    bytes, at least its static inputs, output and one step's digit
    planes, the larger for more rows; the second capture evicts the
    first, whose bytes `engine.graph_bytes_released` counts."""
    from repro_torch.kernels import fused_pbs
    from repro_torch.obs import Telemetry
    ctx, gen = dtree_ctx
    p = ctx.params
    tel = Telemetry(trace=True)
    engine = TaurusEngine.from_context(ctx, telemetry=tel)
    pack = engine.fused_pack
    monkeypatch.setattr(pack, "_graphs", fused_pbs.GraphCache(size=1))
    sizes = {}
    for B in (16, 48):
        cts, polys, want = graph_round(ctx, gen, B)
        outs = [engine.lut_batch(cts, polys) for _ in range(3)]
        assert all(ctx.decrypt(o).tolist() == want for o in outs)
        (graph,) = pack._graphs.graphs.values()
        sizes[B] = graph.bytes
        J, M = (p.k + 1) * p.pbs_level, p.N // 2
        assert sizes[B] >= 8 * B * ((p.n + 1) + p.N + (p.big_n + 1) + 2 * J * M)
    print(f"graph bytes at {p.name}: {sizes}")
    assert sizes[48] > sizes[16]
    assert len([s for s in tel.recorder.spans() if s.args.get("graph") == "capture"]) == 2
    snap = tel.snapshot()["counters"]
    assert snap["engine.graph_bytes_captured"] == sizes[16] + sizes[48]
    assert snap["engine.graph_bytes_released"] == sizes[16]
