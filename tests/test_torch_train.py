"""The port's training substrate (`repro_torch.{optim,data,checkpoint}`,
`runtime.compress`, `launch.train`) against the JAX package's parts, on
the CPU.

No mesh is set (the reference's `train()` cannot run under its host
mesh, ROADMAP queue C), so the reference's pieces run under `jax.jit`
alone; weights are the reference's reduced qwen3-0.6b init, carried by
`repro_torch.interop.lm_params_from_numpy`, and batches are numpy draws
(`jax.random` streams cannot be reproduced).  Tolerances:

- `cosine_schedule`: exact in f32, against the value inside `jax.jit`;
- `AdamW` fed the reference's gradients: `m`, `v` and f32 parameters
  1e-6 of each tensor's largest magnitude, `grad_norm` 1e-6 relative,
  `lr` exact; bf16 parameters equal after the cast;
- `Int8Compressor`: the scale 1e-6 relative.  The two packages sum the
  rms in another order, so the scale may differ in its last bits, which
  moves x / scale by at most 127 x 1e-6; so `q` is equal wherever the
  reference's x / scale lies farther than TIE = 2e-4 from a rounding tie,
  and the residual and the decompressed gradient are within 2e-4 of the
  scale there.  At a tie (a few in ten thousand values) `q` may differ by
  one step and the residual by one scale;
- a train step with compression: step 0 against the reference's jitted
  step, steps 1-2 against the reference's `roundtrip` and
  `adamw_update` called on the port's state.  There the gradients
  themselves differ by about 1e-6 of their largest magnitude
  (tests/test_torch_lm_train.py), which x reaches at about 140 scales,
  so the tie zone and the residual's bound widen to STEP_TIE = 1e-3 of
  the scale; outside the tie elements `m`, `v` are held to 1e-4 and the
  parameters to 1e-4 absolute, the train-step tolerances of
  tests/test_torch_lm_train.py;
- data, checkpoints and `train`: exact (the CPU is deterministic).
"""
import dataclasses
import json
import os
import shutil
import tempfile

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

from repro.configs import qwen3_0_6b as jqwen  # noqa: E402
from repro.data import DataConfig as JDataConfig, SyntheticLMData as JData  # noqa: E402
from repro.launch.steps import make_train_step as jmake_train_step  # noqa: E402
from repro.models import build as jbuild  # noqa: E402
from repro.optim import AdamW as JAdamW, cosine_schedule as jcosine  # noqa: E402
from repro.optim.adamw import adamw_update as jadamw_update  # noqa: E402
from repro.runtime import Int8Compressor as JInt8Compressor  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.core.engine import ConfigError  # noqa: E402
from repro_torch.data import DataConfig, SyntheticLMData  # noqa: E402
from repro_torch.interop import lm_params_from_numpy, lm_params_to_numpy  # noqa: E402
from repro_torch.launch import roofline  # noqa: E402
from repro_torch.launch.steps import make_train_step  # noqa: E402
from repro_torch.launch.train import reduced_config, train  # noqa: E402
from repro_torch.models import build  # noqa: E402
from repro_torch.optim import AdamW, adamw_update, cosine_schedule  # noqa: E402
from repro_torch.runtime import Int8Compressor  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401

ARCH = "qwen3-0.6b"
B, S, CHUNK = 2, 32, 16


@pytest.fixture(scope="module")
def reference():
    jm = jbuild(jqwen.reduced())
    return jm, jm.init(jax.random.PRNGKey(0))


def carried(params):
    return lm_params_from_numpy(build(reduced_config(ARCH), "cpu"),
                                jax.tree.map(np.asarray, params))


def named(tree) -> dict:
    """A reference-layout tree of numpy arrays as the port's named tensors."""
    return dict(carried(tree).state_dict())


def close(got, want, tol):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=tol * max(float(np.abs(want).max()), 1e-30))


def jbatch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def tbatch(batch):
    return {k: torch.tensor(v) for k, v in batch.items()}


def draw_batch(rng, vocab):
    toks = rng.integers(0, vocab, (B, S + 1)).astype(np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


# --- cosine_schedule -----------------------------------------------------------

@pytest.mark.parametrize("peak,warmup,total", [(3e-3, 0, 8), (3e-3, 10, 100),
                                               (3e-4, 30, 300), (3e-3, 1, 3),
                                               (1e-2, 7, 77)])
def test_cosine_schedule_exact_in_f32(peak, warmup, total):
    want = jax.jit(jcosine(peak, warmup, total))
    got = cosine_schedule(peak, warmup, total)
    for step in range(total + 3):
        v = got(step)
        assert v.dtype == np.float32
        assert v == np.asarray(want(jnp.int32(step))), step


# --- AdamW fed the reference's gradients -------------------------------------------

@pytest.mark.parametrize("grad_scale", [1e-3, 10.0], ids=["unclipped", "clipped"])
def test_adamw_update_equals_reference(reference, grad_scale):
    """Three updates from the same gradients, on the reference's layout
    (decay on leaves of two or more dimensions, stacked layers included:
    `Model.decay_mask`)."""
    jm, params = reference
    model = carried(params)
    rng = np.random.default_rng(11)
    jopt = JAdamW(lr=jcosine(3e-3, 1, 3))
    opt = AdamW(lr=cosine_schedule(3e-3, 1, 3))
    jstate = jopt.init(params)
    tparams = dict(model.named_parameters())
    state = opt.init(tparams)
    jupdate = jax.jit(lambda p, s, g, i: jadamw_update(jopt, p, s, g, i))
    for i in range(3):
        grads = jax.tree.map(
            lambda p: (rng.normal(size=p.shape) * grad_scale).astype(np.float32), params)
        params, jstate, want = jupdate(params, jstate, grads, jnp.int32(i))
        state, got = opt.update(tparams, state, named(grads), i, decay=model.decay_mask())
        np.testing.assert_allclose(got["grad_norm"].item(), float(want["grad_norm"]),
                                   rtol=1e-6)
        assert got["lr"].item() == float(want["lr"])
        for ours, theirs in ((lm_params_to_numpy(model), params),
                             (lm_params_to_numpy(model, state["m"]), jstate["m"]),
                             (lm_params_to_numpy(model, state["v"]), jstate["v"])):
            for g, w in zip(jax.tree.leaves(ours), jax.tree.leaves(theirs)):
                close(g, w, 1e-6)


def test_adamw_bf16_params_and_float_lr():
    """bf16 parameters: the update is formed in f32 and cast back; a float
    lr stands for a schedule; decay only on the 2-D tensor by default."""
    rng = np.random.default_rng(12)
    p = {"w": rng.normal(size=(8, 16)).astype(np.float32),
         "b": rng.normal(size=(16,)).astype(np.float32)}
    jp = {k: jnp.asarray(v, jnp.bfloat16) for k, v in p.items()}
    tp = {k: torch.tensor(v).to(torch.bfloat16) for k, v in p.items()}
    jopt, opt = JAdamW(lr=1e-2), AdamW(lr=1e-2)
    jstate, state = jopt.init(jp), opt.init(tp)
    assert all(t.dtype == torch.float32 for t in state["m"].values())
    jupdate = jax.jit(lambda p, s, g, i: jadamw_update(jopt, p, s, g, i))
    for i in range(3):
        g = {k: rng.normal(size=v.shape).astype(np.float32) for k, v in p.items()}
        jp, jstate, want = jupdate(jp, jstate, {k: jnp.asarray(v, jnp.bfloat16)
                                               for k, v in g.items()}, jnp.int32(i))
        state, got = adamw_update(opt, tp, state,
                                  {k: torch.tensor(v).to(torch.bfloat16) for k, v in g.items()},
                                  i)
        assert got["lr"].item() == float(want["lr"])
        for k in p:
            assert tp[k].dtype == torch.bfloat16
            np.testing.assert_array_equal(tp[k].float().numpy(),
                                          np.asarray(jp[k].astype(jnp.float32)))
            close(state["m"][k], jstate["m"][k], 1e-6)
            close(state["v"][k], jstate["v"][k], 1e-6)


# --- Int8Compressor ------------------------------------------------------------

TIE, STEP_TIE = 2e-4, 1e-3


def ties(x, scale, zone=TIE):
    """Where x / scale lies within `zone` of a rounding tie."""
    r = np.asarray(x, np.float64) / float(scale)
    return np.abs(np.abs(r - np.floor(r)) - 0.5) < zone


def test_int8_roundtrip_equals_reference():
    rng = np.random.default_rng(0)
    shapes = [(256, 64), (64,), (2, 64, 128), (1000,)]
    jcomp, comp = JInt8Compressor(), Int8Compressor()
    n_ties = n = 0
    for trial in range(4):
        g = {f"g{i}": (rng.normal(size=s) * 10.0 ** rng.uniform(-4, 0)).astype(np.float32)
             for i, s in enumerate(shapes)}
        ef = {k: (rng.normal(size=v.shape) * 1e-3 * trial).astype(np.float32)
              for k, v in g.items()}
        want_out, want_ef = jax.jit(jcomp.roundtrip)(
            {k: jnp.asarray(v) for k, v in g.items()}, {k: jnp.asarray(v) for k, v in ef.items()})
        got_out, got_ef = comp.roundtrip({k: torch.tensor(v) for k, v in g.items()},
                                         {k: torch.tensor(v) for k, v in ef.items()})
        for k in g:
            jq, jscale, _ = jax.jit(jcomp.compress)(jnp.asarray(g[k]), jnp.asarray(ef[k]))
            q, scale, _ = comp.compress(torch.tensor(g[k]), torch.tensor(ef[k]))
            assert q.dtype == torch.int8 and got_out[k].dtype == torch.float32
            np.testing.assert_allclose(scale.item(), float(jscale), rtol=1e-6)
            tie = ties(g[k] + ef[k], jscale)
            n_ties += int(tie.sum())
            n += tie.size
            diff = np.abs(q.numpy().astype(np.int32) - np.asarray(jq).astype(np.int32))
            assert (diff[~tie] == 0).all() and (diff <= 1).all()
            bound = TIE * float(jscale)
            err = np.abs(got_ef[k].numpy() - np.asarray(want_ef[k]))
            assert (err[~tie] <= bound).all() and (err <= 1.01 * float(jscale) + bound).all()
            err = np.abs(got_out[k].numpy() - np.asarray(want_out[k]))
            assert (err[~tie] <= bound).all()
    assert n_ties < 1e-3 * n


def test_int8_compression_error_feedback_converges():
    """With EF, the accumulated compressed signal tracks the true sum
    (tests/test_runtime.py's check, on the port)."""
    comp = Int8Compressor()
    g_true = torch.tensor(np.random.default_rng(0).normal(size=(64,)),
                          dtype=torch.float32) * 1e-3
    ef = {"g": torch.zeros(64)}
    acc = torch.zeros(64)
    for _ in range(50):
        out, ef = comp.roundtrip({"g": g_true}, ef)
        acc = acc + out["g"]
    np.testing.assert_allclose((acc / 50).numpy(), g_true.numpy(), atol=2e-5)


# --- a train step with compression ------------------------------------------------

def test_compressed_train_steps_equal_reference(reference):
    """Step 0 against the reference's jitted step with `compress` (its
    only working step: its `adamw_update` drops `ef`, so step 1 raises
    KeyError, ROADMAP queue C); steps 1-2 against the reference's
    `roundtrip` and `adamw_update` on the port's state before the step.
    The port keeps `ef` in its state between steps, and scales the
    tensors of one reference leaf (a scanned layer stack) together."""
    jm, params = reference
    model = carried(params)
    jcomp, comp = JInt8Compressor(), Int8Compressor()
    jopt = JAdamW(lr=jcosine(3e-3, 1, 3))
    opt = AdamW(lr=cosine_schedule(3e-3, 1, 3))
    tparams = dict(model.named_parameters())
    state = {**opt.init(tparams), "ef": comp.init(tparams)}

    def jcompress(grads, st):
        g, ef = jcomp.roundtrip(grads, st["ef"])
        return g, {**st, "ef": ef}

    groups = {n: model.reference_leaf(n) for n in tparams}

    def compress(grads, st):
        g, ef = comp.roundtrip(grads, st["ef"], groups)
        return g, {**st, "ef": ef}

    jstep = jax.jit(jmake_train_step(jm.cfg, jopt, loss_chunk=CHUNK, compress=jcompress))
    step = make_train_step(model.cfg, opt, loss_chunk=CHUNK, compress=compress)
    jgrad = jax.jit(jax.value_and_grad(lambda p, b: jm.loss(p, b, loss_chunk=CHUNK)))
    jupdate = jax.jit(lambda p, s, g, i: jadamw_update(jopt, p, s, g, i))
    rng = np.random.default_rng(13)
    for i in range(3):
        batch = draw_batch(rng, jm.cfg.vocab_size)
        # the reference's parts, from the port's state before the step
        p0 = lm_params_to_numpy(model)
        ef0 = lm_params_to_numpy(model, state["ef"])
        st0 = {"m": lm_params_to_numpy(model, state["m"]),
               "v": lm_params_to_numpy(model, state["v"])}
        loss, grads = jgrad(p0, jbatch(batch))
        g_q, ef1 = jax.jit(jcomp.roundtrip)(grads, ef0)
        want_p, want_st, want = jupdate(p0, st0, g_q, jnp.int32(i))
        if i == 0:      # the reference's own train step agrees with its parts
            jp, jst, jmet = jstep(p0, {**st0, "ef": ef0}, jbatch(batch), jnp.int32(0))
            assert set(jst) == {"m", "v"}          # ef dropped: the reference's fault
            assert float(jmet["loss"]) == float(loss)
            for a, b in zip(jax.tree.leaves(jp), jax.tree.leaves(want_p)):
                np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        state, got = step(model, state, tbatch(batch), i)
        assert set(state) == {"m", "v", "ef"}
        np.testing.assert_allclose(got["loss"].item(), float(loss), rtol=1e-5)
        np.testing.assert_allclose(got["grad_norm"].item(), float(want["grad_norm"]),
                                   rtol=1e-5)
        assert got["lr"].item() == float(want["lr"])
        # elements at a rounding tie may quantize one step apart (module doc)
        scales = jax.tree.map(lambda g, e: jcomp.compress(g, e)[1], grads, ef0)
        tie = jax.tree.map(lambda g, e, s: ties(np.asarray(g) + e, s, STEP_TIE),
                           grads, ef0, scales)
        assert sum(int(t.sum()) for t in jax.tree.leaves(tie)) < 1e-2 * model.cfg.param_count()
        for g, w, t, sc in zip(jax.tree.leaves(lm_params_to_numpy(model, state["ef"])),
                               jax.tree.leaves(ef1), jax.tree.leaves(tie),
                               jax.tree.leaves(scales)):
            assert (np.abs(g - np.asarray(w))[~t] <= STEP_TIE * float(sc)).all()
        for ours, theirs, tol, atol in (
                (lm_params_to_numpy(model, state["m"]), want_st["m"], 1e-4, None),
                (lm_params_to_numpy(model, state["v"]), want_st["v"], 1e-4, None),
                (lm_params_to_numpy(model), want_p, None, 1e-4)):
            for g, w, t in zip(jax.tree.leaves(ours), jax.tree.leaves(theirs),
                               jax.tree.leaves(tie)):
                w = np.asarray(w)
                bound = atol if atol is not None else tol * max(float(np.abs(w).max()), 1e-30)
                assert (np.abs(g - w)[~t] <= bound).all()
        assert all(torch.isfinite(e).all() for e in state["ef"].values())


# --- SyntheticLMData --------------------------------------------------------------

def test_data_pipeline_deterministic_and_resumable():
    """tests/test_runtime.py's check, on the port, and its motif table is
    the reference's."""
    cfg = DataConfig(vocab_size=128, seq_len=32, global_batch=4, seed=7)
    d1, d2 = SyntheticLMData(cfg), SyntheticLMData(cfg)
    b1 = d1.batch(123, "cpu")
    b2 = d2.batch(123, "cpu")          # fresh instance, same step -> same batch
    assert b1["tokens"].dtype == torch.int32 and b1["tokens"].shape == (4, 32)
    assert torch.equal(b1["tokens"], b2["tokens"])
    assert torch.equal(b1["labels"], b2["labels"])
    assert not torch.equal(d1.batch(124, "cpu")["tokens"], b1["tokens"])
    # next-token alignment
    assert torch.equal(b1["tokens"][:, 1:], b1["labels"][:, :-1])
    jd = JData(JDataConfig(**dataclasses.asdict(cfg)))
    np.testing.assert_array_equal(d1._motifs.numpy(), np.asarray(jd._motifs))
    np.testing.assert_array_equal(d1._probs.numpy(), np.asarray(jd._probs))


def test_data_motifs_and_zipf_like_reference():
    """Every row holds a motif window (the last one injected is whole),
    and the unigram frequencies of the port's batches and the reference's
    both follow the Zipf table (the top token within 4 sigma)."""
    cfg = DataConfig(vocab_size=256, seq_len=64, global_batch=8, seed=3)
    data, jdata = SyntheticLMData(cfg), JData(JDataConfig(**dataclasses.asdict(cfg)))
    motifs = [tuple(m) for m in data._motifs.tolist()]
    for step in range(3):
        b = data.batch(step, "cpu")
        full = torch.cat([b["tokens"], b["labels"][:, -1:]], dim=1)
        assert int(full.min()) >= 0 and int(full.max()) < cfg.vocab_size
        for row in full.tolist():
            windows = {tuple(row[i:i + cfg.motif_len]) for i in range(len(row))}
            assert windows & set(motifs)
    p0 = float(data._probs[0])
    for toks in (torch.cat([data.batch(s, "cpu")["tokens"] for s in range(20)]).numpy(),
                 np.concatenate([np.asarray(jdata.batch(s)["tokens"]) for s in range(20)])):
        n = toks.size
        assert abs((toks == 0).mean() - p0) < 4 * np.sqrt(p0 * (1 - p0) / n) + 0.05


def test_data_batch_needs_a_device_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        SyntheticLMData(DataConfig(64, 8, 2)).batch(0)


# --- CheckpointManager ---------------------------------------------------------

def test_checkpoint_roundtrip_and_gc():
    with tempfile.TemporaryDirectory() as d:
        mgr = CheckpointManager(d, keep=2)
        tree = {"model": {"a": torch.arange(8.0), "b": torch.ones((3, 3))},
                "m": {"a": torch.zeros(8, dtype=torch.int32)}}
        for step in (10, 20, 30):
            mgr.save(step, {k: {n: t + step for n, t in v.items()} for k, v in tree.items()})
        assert mgr.latest_step() == 30
        restored, step = mgr.restore(tree)
        assert step == 30
        np.testing.assert_allclose(restored["model"]["a"].numpy(), np.arange(8.0) + 30)
        assert restored["m"]["a"].dtype == torch.int32
        assert torch.equal(restored["m"]["a"], torch.full((8,), 30, dtype=torch.int32))
        restored, step = mgr.restore(tree, step=20)
        assert step == 20 and float(restored["model"]["b"][0, 0]) == 21.0
        # GC kept only 2
        assert sorted(n for n in os.listdir(d) if n.startswith("step_")) == \
            ["step_00000020", "step_00000030"]


def test_checkpoint_atomicity_partial_write_ignored():
    with tempfile.TemporaryDirectory() as d:
        mgr = CheckpointManager(d)
        mgr.save(5, {"x": torch.ones(4)})
        # simulate a crashed write: directory without .done marker
        os.makedirs(os.path.join(d, "step_00000099"))
        assert mgr.latest_step() == 5
        with pytest.raises(FileNotFoundError):
            CheckpointManager(os.path.join(d, "empty")).restore({"x": torch.ones(4)})


def test_checkpoint_bf16_by_bits_and_mismatch_raises():
    with tempfile.TemporaryDirectory() as d:
        mgr = CheckpointManager(d)
        w = torch.randn((5, 7), generator=torch.Generator().manual_seed(1)).to(torch.bfloat16)
        path = mgr.save(1, {"model": {"w": w}})
        with np.load(os.path.join(path, "arrays.npz")) as z:
            assert z["model/w"].dtype == np.int16
            np.testing.assert_array_equal(z["model/w"], w.view(torch.int16).numpy())
        with open(os.path.join(path, "tree.json")) as f:
            assert json.load(f)["tensors"]["model/w"] == {"dtype": "bfloat16", "shape": [5, 7]}
        got, _ = mgr.restore({"model": {"w": torch.zeros((5, 7), dtype=torch.bfloat16)}})
        assert got["model"]["w"].dtype == torch.bfloat16 and torch.equal(got["model"]["w"], w)
        with pytest.raises(ValueError, match="model/w"):
            mgr.restore({"model": {"w": torch.zeros((5, 6), dtype=torch.bfloat16)}})
        with pytest.raises(ValueError, match="model/w"):
            mgr.restore({"model": {"w": torch.zeros((5, 7))}})
        with pytest.raises(KeyError, match="mismatch"):
            mgr.restore({"model": {"v": torch.zeros((5, 7), dtype=torch.bfloat16)}})


# --- remat -----------------------------------------------------------------------

class CountMM(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += func in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "qwen2-moe-a2.7b"])
def test_remat_policies_give_the_same_gradients(arch):
    """No remat, "full" and "dots" give equal hidden states and gradients;
    "dots" keeps the matmuls' outputs, so its backward pass runs fewer
    matmuls than "full" does."""
    cfg = reduced_config(arch)
    model = build(cfg, "cpu").init(torch.Generator().manual_seed(3))
    toks = torch.randint(0, cfg.vocab_size, (B, S), generator=torch.Generator().manual_seed(4))
    out, mms = {}, {}
    for remat, policy in ((False, "full"), (True, "full"), (True, "dots")):
        model.zero_grad(set_to_none=True)
        h, aux = model(toks, remat=remat, remat_policy=policy)
        count = CountMM()
        with count:
            (h.square().mean() + aux).backward()
        mms[(remat, policy)] = count.n
        out[(remat, policy)] = [h.detach()] + [p.grad.clone() for p in model.parameters()
                                               if p.grad is not None]
    for key in ((True, "full"), (True, "dots")):
        assert all(torch.equal(a, b) for a, b in zip(out[(False, "full")], out[key]))
    assert mms[(True, "dots")] < mms[(True, "full")]
    with pytest.raises(ValueError, match="remat_policy"):
        model(toks, remat=True, remat_policy="some")


# --- train() ---------------------------------------------------------------------

def test_train_restart_after_failure():
    """Fault tolerance of `train`, as tests/test_runtime.py's docstring
    says: without a checkpoint an unrecoverable step fails loudly; with
    one, an injected failure restores it and the run completes.  Run two
    (resumed at step 4, failing at 6) gives exactly the losses of the same
    run two without the failure, from a copy of the same checkpoint (the
    schedule's total is `steps`, so a 4-step run one and an 8-step run
    differ in lr from step 1; run two's reference is run two)."""
    kw = dict(batch=2, seq=32, reduced=True, log_every=100, device="cpu")
    with tempfile.TemporaryDirectory() as d:
        with pytest.raises(RuntimeError, match="injected"):
            train(ARCH, steps=8, ckpt_dir=d, fail_at_step=4, **kw)
        assert CheckpointManager(d).latest_step() is None
    with tempfile.TemporaryDirectory() as d:
        a, b = os.path.join(d, "a"), os.path.join(d, "b")
        l1, _ = train(ARCH, steps=4, ckpt_dir=a, **kw)
        assert len(l1) == 4 and CheckpointManager(a).latest_step() == 4
        shutil.copytree(a, b)
        l2, stats = train(ARCH, steps=8, ckpt_dir=a, resume=True, fail_at_step=6, **kw)
        clean, clean_stats = train(ARCH, steps=8, ckpt_dir=b, resume=True, **kw)
        assert len(l2) == 6 and len(clean) == 4            # resumed from step 4
        assert l2[:2] == l2[2:4] and l2[2:] == clean
        assert stats["failures"] == 4 and stats["retries"] == 3
        assert clean_stats["failures"] == 0
        assert CheckpointManager(a).latest_step() == 8
        # the two runs two saved the same state
        ta, _ = CheckpointManager(a).restore(CheckpointManager(b).restore(
            _like(a))[0])
        tb, _ = CheckpointManager(b).restore(_like(b))
        for k in ta:
            for n in ta[k]:
                assert torch.equal(ta[k][n], tb[k][n]), (k, n)
    assert all(np.isfinite(l1)) and l1[-1] < l1[0]


def _like(directory):
    """A restore template read from a checkpoint's own tree.json."""
    mgr = CheckpointManager(directory)
    with open(os.path.join(mgr.path(mgr.latest_step()), "tree.json")) as f:
        meta = json.load(f)["tensors"]
    like: dict = {}
    for name, info in meta.items():
        top, rest = name.split("/", 1)
        like.setdefault(top, {})[rest] = torch.zeros(
            info["shape"], dtype=getattr(torch, info["dtype"]))
    return like


def test_train_compress_grads_keeps_ef():
    """`compress_grads` runs past step 1 (the reference's breaks there) and
    its error-feedback buffer is checkpointed with the optimizer state."""
    with tempfile.TemporaryDirectory() as d:
        losses, _ = train(ARCH, steps=3, batch=2, seq=32, ckpt_dir=d, log_every=100,
                          compress_grads=True, device="cpu")
        assert len(losses) == 3 and all(np.isfinite(losses))
        tree, step = CheckpointManager(d).restore(_like(d))
        assert step == 3 and set(tree) == {"model", "m", "v", "ef"}
        ef = torch.cat([t.flatten() for t in tree["ef"].values()])
        assert torch.isfinite(ef).all() and ef.abs().max() > 0


def test_train_refuses_without_a_card_or_with_model_parallel(monkeypatch):
    with pytest.raises(ConfigError, match="model_parallel"):
        train(ARCH, steps=1, model_parallel=2, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train(ARCH, steps=1)


def test_train_step_bound_counts():
    """`train_step_bytes` and `model_flops` at qwen3-0.6b's full width (on
    the meta device: no memory)."""
    from repro_torch.configs.base import ShapeSpec
    cfg = configs.get(ARCH)
    model = build(cfg, "meta")
    n = sum(p.numel() for p in model.parameters())
    pbytes = sum(p.numel() * p.element_size() for p in model.parameters())
    assert pbytes == 2 * n
    assert roofline.train_step_bytes(pbytes, n) == 4 * pbytes + 16 * n
    assert roofline.train_step_bytes(pbytes, n, compress=True) == 4 * pbytes + 24 * n
    flops = roofline.model_flops(cfg, ShapeSpec("t", 256, 8, "train"))
    assert flops == 6.0 * cfg.active_param_count() * 8 * 256
