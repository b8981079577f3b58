"""Prefill and serve step factories: the port of `repro.launch.steps`'
serving half.

Where a reference step takes the param pytree, the port's takes the built
`Model`, which holds its parameters.  Both run without autograd.  The
train step and the sharded lowering (`make_train_step`, `shaped_*`,
`lower_cell`) belong to the training and multi-device paths, not ported
here.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig

F32 = torch.float32


def _check(model, cfg: ArchConfig):
    if model.cfg != cfg:
        raise ValueError(f"step built for {cfg.name} got a model of {model.cfg.name}")


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
