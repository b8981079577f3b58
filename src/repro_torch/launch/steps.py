"""Train, prefill and serve step factories: the port of
`repro.launch.steps` on one card.

Where a reference step takes the param pytree, the port's takes the built
`Model`, which holds its parameters: the train step updates them in place
and returns the optimizer state and metrics, the prefill and serve steps
run without autograd.  Under `sharding.use_mesh` the same steps run on
DTensor parameters.  The dry run's sharded lowering (`shaped_*`,
`lower_cell`) is not ported yet.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig

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
