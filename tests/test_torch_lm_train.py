"""The port's LM training step (`Model.loss`, its gradients, AdamW through
`launch.steps.make_train_step`) against the JAX package's parts, for
every reduced config, on the CPU.

Weights are the reference's `Model.init(PRNGKey(0))`, carried across by
`repro_torch.interop.lm_params_from_numpy`; gradients, parameters and
moments come back through `lm_params_to_numpy`; batches are numpy draws.
No mesh is set: the reference's pieces run under `jax.jit` alone (its
`train()` cannot run under its host mesh, ROADMAP queue C).  Everything
is f32.  Tolerances, each relative to the largest magnitude of the
reference's tensor (leaf by leaf):

- the param layout round trip: exact;
- `Model.loss`: 1e-5, 1e-4 where an SSD or RG-LRU recurrence runs (the
  forward's own tolerances in tests/test_torch_lm.py);
- gradients against `jax.value_and_grad(model.loss)` at `loss_chunk=16`:
  1e-4, 1e-3 with a recurrence (the same products summed in another
  order, through the backward pass as well);
- three train steps against the reference's jitted `make_train_step`:
  loss as above, `grad_norm` 1e-5, `lr` exact, `m` and `v` 1e-4, the
  parameters 1e-4 absolute.  Adam divides each gradient by its own rms,
  so a gradient near zero turns its 1e-6 relative difference into a
  visible share of a step of at most `lr` (3e-3): up to 2e-5 was seen.
"""
import functools
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.launch.steps import make_train_step as jmake_train_step  # noqa: E402
from repro.models import build as jbuild  # noqa: E402
from repro.optim import AdamW as JAdamW, cosine_schedule as jcosine  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.interop import lm_params_from_numpy, lm_params_to_numpy  # noqa: E402
from repro_torch.launch.steps import make_train_step  # noqa: E402
from repro_torch.launch.train import reduced_config  # noqa: E402
from repro_torch.models import build  # noqa: E402
from repro_torch.optim import AdamW, cosine_schedule  # noqa: E402

ARCHS = list(configs.ARCH_IDS)
RECURRENT = ("mamba2-130m", "recurrentgemma-2b")
B, S, CHUNK = 2, 32, 16


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    # xdist workers share the cores with XLA's threads
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _reference(arch):
    """The reference's reduced model and its init(PRNGKey(0)) params."""
    cfg = importlib.import_module(
        "repro.configs." + arch.replace("-", "_").replace(".", "_")).reduced()
    jm = jbuild(cfg)
    return jm, jm.init(jax.random.PRNGKey(0))


def carried(arch):
    """A fresh port model holding the reference's weights."""
    _, params = _reference(arch)
    return lm_params_from_numpy(build(reduced_config(arch), "cpu"),
                                jax.tree.map(np.asarray, params))


def batches(cfg, n, seed=5):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        toks = rng.integers(0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
        b = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        if cfg.frontend != "none":
            b["frontend"] = rng.normal(
                size=(B, cfg.frontend_len, cfg.frontend_dim)).astype(np.float32)
        out.append(b)
    return out


def close_trees(got, want, tol, atol=None):
    """Leaf by leaf: |got - want| <= tol * max|want| (or `atol`)."""
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        w = np.asarray(w)
        bound = atol if atol is not None else tol * max(float(np.abs(w).max()), 1e-30)
        np.testing.assert_allclose(g, w, rtol=0, atol=bound)


def tol_of(arch, plain, recurrent):
    return recurrent if arch in RECURRENT else plain


@pytest.mark.parametrize("arch", ARCHS)
def test_params_to_numpy_inverts_from_numpy(arch):
    _, params = _reference(arch)
    want = jax.tree.map(np.asarray, params)
    got = lm_params_to_numpy(carried(arch))
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        assert g.dtype == w.dtype and np.array_equal(g, w)


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_equal_reference(arch):
    jm, params = _reference(arch)
    model = carried(arch)
    (batch,) = batches(model.cfg, 1)
    want, want_g = jax.jit(jax.value_and_grad(
        lambda p, b: jm.loss(p, b, loss_chunk=CHUNK)))(
            params, {k: jnp.asarray(v) for k, v in batch.items()})
    loss = model.loss({k: torch.tensor(v) for k, v in batch.items()}, loss_chunk=CHUNK)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want), rtol=tol_of(arch, 1e-5, 1e-4))
    got_g = lm_params_to_numpy(model, {n: p.grad for n, p in model.named_parameters()})
    close_trees(got_g, want_g, tol_of(arch, 1e-4, 1e-3))


@pytest.mark.parametrize("arch", ARCHS)
def test_train_steps_equal_reference(arch):
    """Three steps of `make_train_step` (warmup 1 of 3: lr 0, peak, the
    cosine's floor side) against the reference's jitted train step."""
    jm, params = _reference(arch)
    model = carried(arch)
    jopt = JAdamW(lr=jcosine(3e-3, warmup=1, total=3))
    opt = AdamW(lr=cosine_schedule(3e-3, warmup=1, total=3))
    jstep = jax.jit(jmake_train_step(jm.cfg, jopt, loss_chunk=CHUNK))
    step = make_train_step(model.cfg, opt, loss_chunk=CHUNK)
    jstate = jopt.init(params)
    state = opt.init(dict(model.named_parameters()))
    for i, batch in enumerate(batches(model.cfg, 3)):
        params, jstate, want = jstep(params, jstate,
                                     {k: jnp.asarray(v) for k, v in batch.items()},
                                     jnp.int32(i))
        state, got = step(model, state, {k: torch.tensor(v) for k, v in batch.items()}, i)
        np.testing.assert_allclose(got["loss"].item(), float(want["loss"]),
                                   rtol=tol_of(arch, 1e-5, 1e-4))
        np.testing.assert_allclose(got["grad_norm"].item(), float(want["grad_norm"]),
                                   rtol=1e-5)
        assert got["lr"].item() == float(want["lr"])
        close_trees(lm_params_to_numpy(model, state["m"]), jstate["m"], 1e-4)
        close_trees(lm_params_to_numpy(model, state["v"]), jstate["v"], 1e-4)
        close_trees(lm_params_to_numpy(model), params, None, atol=1e-4)
