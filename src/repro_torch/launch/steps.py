"""Train, prefill and serve step factories: the port of
`repro.launch.steps` on one card.

Where a reference step takes the param pytree, the port's takes the built
`Model`, which holds its parameters: the train step updates them in place
and returns the optimizer state and metrics, the prefill and serve steps
run without autograd.  Under `sharding.use_mesh` the same steps run on
DTensor parameters.

The dry run's cells: `shaped_params`, `shaped_opt_state` and
`shaped_cache` lay a cell's state out without data (meta shards of
DTensors on a mesh), and `lower_cell` returns a callable that runs the
cell's step once on them, as the reference's `lower_cell` returns the
lowered step for XLA to compile; `launch.op_analysis` counts its ops.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig, ShapeSpec

F32 = torch.float32


def _check(model, cfg: ArchConfig):
    if model.cfg != cfg:
        raise ValueError(f"step built for {cfg.name} got a model of {model.cfg.name}")


def make_train_step(cfg: ArchConfig, opt, *, loss_chunk: int = 512, compress=None):
    """Returns train_step(model, opt_state, batch, step) -> (opt_state,
    metrics): the loss and its gradients through autograd, then the
    optional `compress(grads, opt_state) -> (grads, opt_state)` (int8
    gradient compression with error feedback, `repro_torch.runtime.
    compress`), then `opt` (an `AdamW`, decaying the parameters the
    reference decays: `Model.decay_mask`), which writes the parameters in
    place.  metrics: "loss" (before the update), "grad_norm", "lr"."""

    def train_step(model, opt_state, batch, step):
        _check(model, cfg)
        params = dict(model.named_parameters())
        model.zero_grad(set_to_none=True)
        loss = model.loss(batch, loss_chunk=loss_chunk)
        loss.backward()
        # a parameter the batch does not reach (a frontend projection
        # without a frontend) has no gradient: zeros, as in the reference
        grads = {n: torch.zeros_like(p) if p.grad is None else p.grad
                 for n, p in params.items()}
        if compress is not None:
            grads, opt_state = compress(grads, opt_state)
        opt_state, metrics = opt.update(params, opt_state, grads, step,
                                        decay=model.decay_mask())
        model.zero_grad(set_to_none=True)      # frees the gradients
        metrics["loss"] = loss.detach()
        return opt_state, metrics

    return train_step


def make_prefill_step(cfg: ArchConfig):
    """Forward-only scoring step (the inference-prefill shape cells):
    prefill_step(model, batch) -> last-position logits (B, V) f32."""

    @torch.no_grad()
    def prefill_step(model, batch):
        _check(model, cfg)
        h, _ = model.forward(batch["tokens"], batch.get("frontend"))
        # last-position logits only (prefill hands off to decode)
        return h[:, -1].to(F32) @ model.head().to(F32)

    return prefill_step


def make_serve_step(cfg: ArchConfig):
    """One-token decode step against a deep KV/state cache:
    serve_step(model, cache, tokens, pos) -> (logits, cache), the cache
    written in place."""

    def serve_step(model, cache, tokens, pos):
        _check(model, cfg)
        return model.decode_step(cache, tokens, pos)

    return serve_step


# --------------------------------------------------------------------------
# the dry run's cells: state without data, laid out on a mesh
# --------------------------------------------------------------------------

def shaped_params(cfg: ArchConfig, mesh=None, mode: str = "train", device="meta"):
    """A `Model` of `cfg` whose parameters hold no data (meta tensors by
    default), laid out on `mesh` by `launch.mesh.param_shardings`."""
    from repro_torch.launch.mesh import distribute_params
    from repro_torch.models import build
    model = build(cfg, device)
    if mesh is not None:
        distribute_params(model, mesh, mode)
    return model


def shaped_opt_state(cfg: ArchConfig, opt, model) -> dict:
    """The AdamW state of `model`'s parameters, in their layouts."""
    _check(model, cfg)
    return opt.init(dict(model.named_parameters()))


def shaped_cache(cfg: ArchConfig, shape: ShapeSpec, mesh=None, device="meta",
                 model=None) -> list:
    """The decode cache of a cell (global batch x seq_len) without data,
    each tensor laid out on `mesh` by `launch.mesh.cache_specs`."""
    from repro_torch.launch.mesh import cache_specs, placements
    from repro_torch.models import build
    model = model if model is not None else build(cfg, device)
    cache = model.init_cache(shape.global_batch, shape.seq_len)
    if mesh is None:
        return cache
    from torch.distributed.tensor import distribute_tensor
    specs = cache_specs(cache, mesh, shape.global_batch)
    return [{n: distribute_tensor(t, mesh, placements(specs[i][n], mesh))
             if isinstance(t, torch.Tensor) else t for n, t in layer.items()}
            for i, layer in enumerate(cache)]


def state_tensors(*trees) -> list:
    """Every tensor in `trees` (models, or nested dicts / lists)."""
    from torch.utils._pytree import tree_leaves
    out = []
    for tree in trees:
        if isinstance(tree, torch.nn.Module):
            tree = list(tree.parameters())
        out += [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]
    return out


def lower_cell(cfg: ArchConfig, shape: ShapeSpec, mesh, *, loss_chunk: int = 512,
               device="meta"):
    """The step of one (arch, shape, mesh) cell on state without data.

    Returns (run, args): `run()` runs the train, prefill or decode step
    once under `sharding.use_mesh(mesh)`, and args lists the step's
    argument tensors (parameters, optimizer state, inputs, cache), whose
    shards the reference's `argument_size_in_bytes` counts where the step
    reads them (`launch.op_analysis.count`)."""
    from repro_torch.launch.mesh import input_specs
    from repro_torch.models.sharding import use_mesh
    from repro_torch.optim import AdamW
    inputs = input_specs(cfg, shape, mesh, device)
    if shape.kind == "train":
        opt = AdamW()
        model = shaped_params(cfg, mesh, "train", device)
        state = {"opt": shaped_opt_state(cfg, opt, model)}
        step = make_train_step(cfg, opt, loss_chunk=loss_chunk)

        def run():
            with use_mesh(mesh):
                state["opt"], metrics = step(model, state["opt"], inputs, 0)
            return metrics
        return run, state_tensors(model, state["opt"], inputs)
    model = shaped_params(cfg, mesh, "serve", device)
    if shape.kind == "prefill":
        step = make_prefill_step(cfg)

        def run():
            with use_mesh(mesh):
                return step(model, inputs)
        return run, state_tensors(model, inputs)
    cache = shaped_cache(cfg, shape, mesh, device, model)
    step = make_serve_step(cfg)

    def run():
        with use_mesh(mesh):
            return step(model, cache, inputs["tokens"], inputs["pos"])
    return run, state_tensors(model, cache, inputs)
