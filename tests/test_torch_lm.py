"""The port's LM serving path (`repro_torch.{configs,models}`,
`launch/{steps,serve}.py`) against the JAX package's, on the CPU.

Weights are the reference's `Model.init(PRNGKey(0))` of each reduced
config, carried across by `repro_torch.interop.lm_params_from_numpy`;
inputs come from numpy seeds.  Everything is f32.  Tolerances:

- configs, shapes, parameter counts, greedy tokens: exact;
- elementwise functions (`rms_norm`, `rope`): 1e-6;
- attention, MLP, MoE and whole-model forwards / decode logits: 1e-5
  (the same products summed in another order);
- the recurrences (`ssd_chunked`, the RG-LRU scan and every model with
  one): 1e-4 relative and absolute.  The reference's associative scan and
  chunked SSD combine terms in another order than the port's doubling
  scan and loops, and decays near 1 carry each rounding forward;
- the port's own decode against its forward: the reference's
  rtol = atol = 2e-3 (tests/test_arch_smoke.py::test_decode_matches_prefill).
"""
import dataclasses
import functools
import importlib
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.configs as jconfigs  # noqa: E402
from repro.configs import base as jbase  # noqa: E402
from repro.launch.steps import make_serve_step as jmake_serve_step  # noqa: E402
from repro.models import build as jbuild, layers as jl, rglru as jr, ssd as js  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.configs import base  # noqa: E402
from repro_torch.core.engine import ConfigError  # noqa: E402
from repro_torch.interop import lm_params_from_numpy  # noqa: E402
from repro_torch.launch.serve import serve  # noqa: E402
from repro_torch.launch.steps import make_prefill_step, make_serve_step  # noqa: E402
from repro_torch.launch.train import reduced_config  # noqa: E402
from repro_torch.models import build, layers, rglru, ssd  # noqa: E402
from repro_torch.models.model import POS_SENTINEL  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401

ARCHS = list(configs.ARCH_IDS)
RECURRENT = ("mamba2-130m", "recurrentgemma-2b")
B, S = 2, 16


def ref_reduced(arch):
    return importlib.import_module(
        "repro.configs." + arch.replace("-", "_").replace(".", "_")).reduced()


def t(a):
    return torch.tensor(np.asarray(a))


def close(got, want, tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=tol, atol=tol)


def load(module, jparams):
    """Load a reference param dict (nested, dotted) into a port module."""
    def flat(tree, prefix=""):
        for k, v in tree.items():
            yield from (flat(v, f"{prefix}{k}.") if isinstance(v, dict)
                        else [(f"{prefix}{k}", t(v))])
    module.load_state_dict(dict(flat(jparams)), strict=True)
    return module


def tol_of(arch):
    return 1e-4 if arch in RECURRENT else 1e-5


# --- configs ------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_config_equals_reference(arch):
    got, want = configs.get(arch), jconfigs.get(arch)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert dataclasses.asdict(reduced_config(arch)) == dataclasses.asdict(ref_reduced(arch))
    for c, j in ((got, want), (reduced_config(arch), ref_reduced(arch))):
        assert c.param_count() == j.param_count()
        assert c.active_param_count() == j.active_param_count()
        assert (c.attn_free, c.sub_quadratic, c.is_moe) == (j.attn_free, j.sub_quadratic,
                                                            j.is_moe)
    assert base.applicable_shapes(got) == jbase.applicable_shapes(want)


def test_registry_and_shapes_equal_reference():
    assert configs.ARCH_IDS == jconfigs.ARCH_IDS
    assert sorted(base.REGISTRY) == sorted(jbase.REGISTRY)
    assert {k: dataclasses.asdict(v) for k, v in base.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in jbase.SHAPES.items()}


# --- layers -------------------------------------------------------------------

@pytest.mark.parametrize("plus_one", [False, True])
def test_rms_norm(plus_one):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 5, 64)).astype(np.float32) * 3
    w = rng.normal(size=(64,)).astype(np.float32)
    want = jax.jit(lambda x, w: jl.rms_norm(x, w, 1e-6, plus_one))(x, w)
    close(layers.rms_norm(t(x), t(w), 1e-6, plus_one), want, 1e-6)


def test_rope():
    rng = np.random.default_rng(1)
    q = rng.normal(size=(2, 16, 4, 32)).astype(np.float32)
    pos = rng.integers(0, 64, (2, 16)).astype(np.int32)
    want = jax.jit(lambda q, pos: jl.rope(q, pos, 1e6))(q, pos)
    close(layers.rope(t(q), t(pos), 1e6), want, 1e-6)


@pytest.mark.parametrize("window", [0, 8])
def test_flash_attention_chunked(window):
    """Skv = 64 in chunks of 16, GQA rep 2; with window 8 whole chunks are
    masked for later queries (the running-max guard)."""
    rng = np.random.default_rng(2)
    q = rng.normal(size=(2, 64, 4, 16)).astype(np.float32)
    k, v = (rng.normal(size=(2, 64, 2, 16)).astype(np.float32) for _ in range(2))
    pos = np.broadcast_to(np.arange(64, dtype=np.int32), (2, 64)).copy()
    got = layers.flash_attention(t(q), t(k), t(v), t(pos), t(pos), window=window, kv_chunk=16)
    want = jax.jit(functools.partial(jl.flash_attention, window=window, kv_chunk=16))(
        q, k, v, pos, pos)
    close(got, want, 1e-5)


@pytest.mark.parametrize("window", [0, 3])
def test_flash_attention_decode_with_sentinel_slots(window):
    """Row 0 has 5 written slots of 16; row 1 none: its output is 0."""
    rng = np.random.default_rng(3)
    q = rng.normal(size=(2, 1, 4, 16)).astype(np.float32)
    k, v = (rng.normal(size=(2, 16, 2, 16)).astype(np.float32) for _ in range(2))
    kv_pos = np.full((2, 16), POS_SENTINEL, np.int32)
    kv_pos[0, :5] = np.arange(5)
    q_pos = np.full((2, 1), 4, np.int32)
    got = layers.flash_attention(t(q), t(k), t(v), t(q_pos), t(kv_pos), window=window)
    want = jax.jit(functools.partial(jl.flash_attention, window=window))(
        q, k, v, q_pos, kv_pos)
    close(got, want, 1e-5)
    assert torch.equal(got[1], torch.zeros_like(got[1]))


@pytest.mark.parametrize("gated,act", [(True, "silu"), (True, "gelu"), (False, "silu"),
                                       (False, "gelu")])
def test_mlp_block(gated, act):
    cfg = dataclasses.replace(ref_reduced("qwen3-0.6b"), gated_mlp=gated, act=act)
    p = jl.MlpParams.init(jax.random.PRNGKey(1), cfg, jnp.float32)
    mlp = load(layers.Mlp(cfg.d_model, cfg.d_ff, gated, act, torch.float32, "cpu"), p)
    x = np.random.default_rng(4).normal(size=(2, 8, cfg.d_model)).astype(np.float32)
    with torch.no_grad():
        close(mlp(t(x)), jax.jit(lambda p, x: jl.mlp_block(p, x, cfg))(p, x), 1e-5)


@pytest.mark.parametrize("dispatch", ["einsum", "gather"])
@pytest.mark.parametrize("capacity_factor", [16.0, 1.0])
def test_moe_block(dispatch, capacity_factor):
    """Dropless (16) and with capacity drops (1.0: C = 8 for 32 tokens x
    top-2 over 8 experts); out and the Switch aux loss."""
    cfg = dataclasses.replace(ref_reduced("qwen2-moe-a2.7b"), moe_dispatch=dispatch,
                              moe_capacity_factor=capacity_factor)
    pcfg = dataclasses.replace(reduced_config("qwen2-moe-a2.7b"), moe_dispatch=dispatch,
                               moe_capacity_factor=capacity_factor)
    p = jl.MoeParams.init(jax.random.PRNGKey(2), cfg, jnp.float32)
    moe = load(layers.Moe(pcfg, torch.float32, "cpu"), p)
    x = np.random.default_rng(5).normal(size=(2, 16, cfg.d_model)).astype(np.float32)
    want, want_aux = jax.jit(lambda p, x: jl.moe_block(p, x, cfg))(p, x)
    with torch.no_grad():
        got, aux = moe(t(x))
    close(got, want, 1e-5)
    close(aux, want_aux, 1e-5)


# --- recurrences --------------------------------------------------------------

def test_ssd_chunked():
    rng = np.random.default_rng(6)
    x = rng.normal(size=(2, 32, 4, 8)).astype(np.float32)
    dt = np.log1p(np.exp(rng.normal(size=(2, 32, 4)))).astype(np.float32)
    a_log = np.log(np.linspace(1.0, 16.0, 4)).astype(np.float32)
    Bm, Cm = (rng.normal(size=(2, 32, 16)).astype(np.float32) for _ in range(2))
    D = rng.normal(size=(4,)).astype(np.float32)
    y, H = ssd.ssd_chunked(*(t(a) for a in (x, dt, a_log, Bm, Cm, D)), chunk=8)
    jy, jH = jax.jit(functools.partial(js.ssd_chunked, chunk=8))(x, dt, a_log, Bm, Cm, D)
    close(y, jy, 1e-4)
    close(H, jH, 1e-4)


def test_rglru_scan_with_h0():
    rng = np.random.default_rng(7)
    x = rng.normal(size=(2, 24, 16)).astype(np.float32)
    a_log = -np.abs(rng.normal(size=(2, 24, 16)) * 0.3).astype(np.float32)
    r, i = (1 / (1 + np.exp(-rng.normal(size=(2, 24, 16)))) for _ in range(2))
    r, i = r.astype(np.float32), i.astype(np.float32)
    h0 = rng.normal(size=(2, 16)).astype(np.float32)
    close(rglru.rglru_scan(t(x), t(a_log), t(r), t(i), t(h0)),
          jax.jit(jr.rglru_scan)(x, a_log, r, i, h0), 1e-4)


def _decode_states(rng, cache):
    return {k: rng.normal(size=v.shape).astype(np.float32) for k, v in cache.items()}


def test_ssd_block_decode():
    """Four one-token steps from a random conv state and SSM state."""
    cfg = ref_reduced("mamba2-130m")
    p = js.SsdParams.init(jax.random.PRNGKey(3), cfg, jnp.float32)
    mod = load(ssd.Ssd(reduced_config("mamba2-130m"), torch.float32, "cpu"), p)
    rng = np.random.default_rng(8)
    state = _decode_states(rng, js.ssd_init_cache(cfg, 2, jnp.float32))
    jcache = {k: jnp.asarray(v) for k, v in state.items()}
    cache = {k: t(v) for k, v in state.items()}
    step = jax.jit(lambda p, x, c: js.ssd_block(p, x, cfg, cache=c))
    for _ in range(4):
        x = rng.normal(size=(2, 1, cfg.d_model)).astype(np.float32)
        want, jcache = step(p, x, jcache)
        with torch.no_grad():
            got, cache = mod(t(x), cache=cache)
        close(got, want, 1e-5)
    for k in state:
        close(cache[k], jcache[k], 1e-5)


def test_rglru_block_decode():
    cfg = ref_reduced("recurrentgemma-2b")
    p = jr.RgLruParams.init(jax.random.PRNGKey(4), cfg, jnp.float32)
    mod = load(rglru.RgLru(reduced_config("recurrentgemma-2b"), torch.float32, "cpu"), p)
    rng = np.random.default_rng(9)
    state = _decode_states(rng, jr.rglru_init_cache(cfg, 2, jnp.float32))
    jcache = {k: jnp.asarray(v) for k, v in state.items()}
    cache = {k: t(v) for k, v in state.items()}
    step = jax.jit(lambda p, x, c: jr.rglru_block(p, x, cfg, cache=c))
    for _ in range(4):
        x = rng.normal(size=(2, 1, cfg.d_model)).astype(np.float32)
        want, jcache = step(p, x, jcache)
        with torch.no_grad():
            got, cache = mod(t(x), cache=cache)
        close(got, want, 1e-5)
    for k in state:
        close(cache[k], jcache[k], 1e-5)


# --- whole models on carried weights ---------------------------------------------

@functools.lru_cache(maxsize=None)
def _carry(arch):
    """The reference model of a reduced config, its `init(PRNGKey(0))`
    weights carried into the port, and the reference's jitted serve step (its
    `decode_step`)."""
    jcfg = ref_reduced(arch)
    jm = jbuild(jcfg)
    params = jm.init(jax.random.PRNGKey(0))
    model = lm_params_from_numpy(build(reduced_config(arch), "cpu"),
                                 jax.tree.map(np.asarray, params))
    rng = np.random.default_rng(3)
    toks = rng.integers(0, jcfg.vocab_size, (B, S)).astype(np.int32)
    return SimpleNamespace(arch=arch, jm=jm, params=params, model=model, toks=toks,
                           step=jax.jit(jmake_serve_step(jcfg)))


@pytest.fixture(scope="module", params=ARCHS)
def carried(request):
    return _carry(request.param)


def _decode(c, steps, max_len):
    """(port logits, reference logits) after each of `steps` decode steps."""
    cache, jcache = c.model.init_cache(B, max_len), c.jm.init_cache(B, max_len)
    toks = np.concatenate([c.toks] * (steps // S + 1), axis=1)
    out = []
    for i in range(steps):
        pos = np.full((B, 1), i, np.int32)
        got, cache = c.model.decode_step(cache, t(toks[:, i:i + 1]), t(pos))
        want, jcache = c.step(c.params, jcache, jnp.asarray(toks[:, i:i + 1]),
                              jnp.asarray(pos))
        out.append((got, want))
    return out


def test_forward_equals_reference(carried):
    cfg = carried.model.cfg
    fe = None
    if cfg.frontend != "none":
        fe = np.random.default_rng(4).normal(
            size=(B, cfg.frontend_len, cfg.frontend_dim)).astype(np.float32)
    want, want_aux = jax.jit(carried.jm.forward)(
        carried.params, jnp.asarray(carried.toks), None if fe is None else jnp.asarray(fe))
    with torch.no_grad():
        got, aux = carried.model.forward(t(carried.toks), None if fe is None else t(fe))
    close(got, want, tol_of(carried.arch))
    close(aux, want_aux, 1e-5)


def test_decode_steps_equal_reference(carried):
    """16 decode_step logits (every step) against the reference's."""
    for got, want in _decode(carried, S, S):
        close(got, want, tol_of(carried.arch))


def test_decode_matches_prefill(carried):
    """The port's decode against its own forward (the reference's check)."""
    got, _ = _decode(carried, S, S)[-1]
    want = make_prefill_step(carried.model.cfg)(carried.model, {"tokens": t(carried.toks)})
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=2e-3, atol=2e-3)


def test_local_ring_buffer_wraps_like_reference():
    """recurrentgemma's local layers keep a 16-slot ring buffer (window 16);
    24 steps overwrite the first 8 slots."""
    c = _carry("recurrentgemma-2b")
    cache = c.model.init_cache(B, 24)
    assert cache[2]["k"].shape[1] == 16
    for got, want in _decode(c, 24, 24):
        close(got, want, tol_of(c.arch))


def test_serve_step_loops_give_reference_tokens(carried):
    """Both packages' `make_serve_step` greedy loops on the same carried
    weights and prompts: 8 prompt tokens, then 8 generated ones."""
    jcfg, params, model = carried.jm.cfg, carried.params, carried.model
    prompts = np.random.default_rng(5).integers(0, jcfg.vocab_size, (B, 8)).astype(np.int32)
    jstep, step = carried.step, make_serve_step(model.cfg)
    jcache, cache = carried.jm.init_cache(B, 16), model.init_cache(B, 16)
    jtok, tok, got, want = None, None, [], []
    for i in range(16):
        pos = np.full((B, 1), i, np.int32)
        jin = jnp.asarray(prompts[:, i:i + 1]) if i < 8 else jtok
        tin = t(prompts[:, i:i + 1]) if i < 8 else tok
        jl_, jcache = jstep(params, jcache, jin, jnp.asarray(pos))
        tl, cache = step(model, cache, tin, t(pos))
        jtok = jnp.argmax(jl_, axis=-1)[:, None].astype(jnp.int32)
        tok = torch.argmax(tl, dim=-1)[:, None].to(torch.int32)
        if i >= 7:
            want.append(np.asarray(jtok)[:, 0])
            got.append(tok[:, 0].numpy())
    assert np.array_equal(np.stack(got, 1), np.stack(want, 1))


# --- init, interop, serve --------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_own_init_has_reference_layout(arch):
    """The port's seeded init fills every parameter the reference's init
    makes, with its shape and dtype, deterministically per seed."""
    jcfg = ref_reduced(arch)
    shapes = jax.eval_shape(lambda: jbuild(jcfg).init(jax.random.PRNGKey(0)))
    zeros = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    ref = lm_params_from_numpy(build(reduced_config(arch), "cpu"), zeros).state_dict()
    a = build(reduced_config(arch), "cpu").init(torch.Generator().manual_seed(3))
    b = build(reduced_config(arch), "cpu").init(torch.Generator().manual_seed(3))
    for name, p in a.state_dict().items():
        assert p.shape == ref[name].shape and p.dtype == ref[name].dtype, name
        assert torch.isfinite(p).all() and torch.equal(p, b.state_dict()[name]), name
    assert abs(a.embed.std().item() - 0.02) < 2e-3


def test_init_distributions():
    m = build(reduced_config("recurrentgemma-2b"), "cpu").init(torch.Generator().manual_seed(0))
    wq = m.layers[2].mixer.wq
    bound = 2 / np.sqrt(wq.shape[0])
    assert wq.abs().max().item() <= bound
    assert 0.8 < wq.std().item() * np.sqrt(wq.shape[0]) < 0.95   # truncated at 2 sigma
    a = torch.sigmoid(m.layers[0].mixer.Lambda)
    assert 0.9 <= a.min().item() and a.max().item() <= 0.999 + 1e-6


def test_lm_params_from_numpy_bfloat16_bits_and_errors():
    jcfg = dataclasses.replace(ref_reduced("qwen3-0.6b"), dtype="bfloat16")
    params = jax.tree.map(np.asarray, jbuild(jcfg).init(jax.random.PRNGKey(0)))
    cfg = dataclasses.replace(reduced_config("qwen3-0.6b"), dtype="bfloat16")
    model = lm_params_from_numpy(build(cfg, "cpu"), params)
    assert model.embed.dtype == torch.bfloat16
    assert np.array_equal(model.embed.view(torch.int16).numpy(),
                          params["embed"].view(np.int16))
    wq = params["blocks"]["l0"]["mixer"]["wq"][1]
    assert np.array_equal(model.layers[1].mixer.wq.view(torch.int16).numpy(),
                          wq.view(np.int16))
    del params["final_norm"]
    with pytest.raises(KeyError, match="final_norm"):
        lm_params_from_numpy(build(cfg, "cpu"), params)


def test_serve_end_to_end_on_cpu():
    run = serve("qwen3-0.6b", batch=2, prompt_len=6, gen=5, device="cpu")
    assert run.tokens.shape == (2, 5) and run.logits.shape == (2, 256)
    assert run.tokens.min() >= 0 and run.tokens.max() < 256
    # the last logits are the forward's at the last position of prompt ++ tokens
    seq = torch.cat([run.prompts, torch.as_tensor(run.tokens, dtype=torch.int32)], dim=1)
    want = make_prefill_step(run.model.cfg)(run.model, {"tokens": seq})
    np.testing.assert_allclose(run.logits.numpy(), want.numpy(), rtol=2e-3, atol=2e-3)
    again = serve("qwen3-0.6b", batch=2, prompt_len=6, gen=5, device="cpu")
    assert np.array_equal(run.tokens, again.tokens)


def test_serve_refuses_model_parallel_and_missing_card(monkeypatch):
    with pytest.raises(ConfigError, match="process group"):
        serve("qwen3-0.6b", model_parallel=2, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve("qwen3-0.6b")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build(reduced_config("qwen3-0.6b"))


def test_decode_cache_overflow_raises():
    m = build(reduced_config("qwen3-0.6b"), "cpu").init(torch.Generator().manual_seed(0))
    cache = m.init_cache(1, 2)
    tok = torch.zeros((1, 1), dtype=torch.int32)
    for i in range(2):
        m.decode_step(cache, tok, torch.full((1, 1), i, dtype=torch.int32))
    with pytest.raises(ValueError, match="full"):
        m.decode_step(cache, tok, torch.full((1, 1), 2, dtype=torch.int32))
