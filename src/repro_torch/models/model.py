"""Composable LM builder for the assigned architecture pool: the port of
`repro.models.model`.

`build(cfg, device)` returns a `Model` (an `nn.Module`) whose parameters
are allocated on the device but not yet initialised:

    init(generator)                   -> the model, initialised in place
    forward(tokens, frontend)         -> ((B, S, d) final hidden, MoE aux)
    loss(batch)                       -> scalar (chunked CE, no (B, S, V))
    init_cache(batch, max_len)        -> decode cache (one dict per layer)
    decode_step(cache, tokens, pos)   -> (logits, cache), cache written in place

Layers are one flat `ModuleList`: the reference's ``L // period``
macro-blocks of ``period = len(cfg.layer_pattern)`` layers (its scanned,
stacked params), then the ``L % period`` tail.  Every sub-layer is
pre-norm residual; MoE configs replace the dense MLP.
"""
from __future__ import annotations

import functools
import math

import torch
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models import rglru as R
from repro_torch.models import ssd as S
from repro_torch.models.sharding import (constrain, logsumexp, replicated_like, take_label,
                                         take_rows)

F32 = torch.float32
POS_SENTINEL = 1 << 30  # unwritten KV slots: fails the causal mask
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
# matmuls without batch dimensions: what the reference's "dots" remat policy
# (`dots_with_no_batch_dims_saveable`) keeps for the backward pass
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    return CheckpointPolicy.MUST_SAVE if op in _DOTS else CheckpointPolicy.PREFER_RECOMPUTE


def _chunk_loss(hx, lx, head):
    """Summed cross-entropy of one chunk: logsumexp - gold, over f32 logits
    (both operands cast to f32: bf16 products are exact in f32)."""
    # the head whole over the data axes (its FSDP shard gathered), so the
    # product keeps the chunk's batch shard and splits the vocabulary
    head = constrain(head, None, "model")
    logits = constrain(hx.to(F32) @ head.to(F32), "batch", None, "model")
    return torch.sum(logsumexp(logits) - take_label(logits, lx))


class Layer(nn.Module):
    """One (mixer + MLP) residual pair of kind attn | local | ssd | rglru."""

    def __init__(self, cfg: ArchConfig, kind: str, dtype, device):
        super().__init__()
        self.cfg, self.kind = cfg, kind
        self.pre_norm = L.param((cfg.d_model,), dtype, device)
        if kind in ("attn", "local"):
            self.mixer = L.Attention(cfg, dtype, device)
        elif kind == "ssd":
            self.mixer = S.Ssd(cfg, dtype, device)
        elif kind == "rglru":
            self.mixer = R.RgLru(cfg, dtype, device)
        else:
            raise ValueError(kind)
        if cfg.is_moe:
            self.moe = L.Moe(cfg, dtype, device)
        elif cfg.d_ff > 0:
            self.mlp = L.Mlp(cfg.d_model, cfg.d_ff, cfg.gated_mlp, cfg.act, dtype, device)
        if cfg.is_moe or cfg.d_ff > 0:   # else a mixer-only layer (e.g. mamba2)
            self.mlp_norm = L.param((cfg.d_model,), dtype, device)

    @torch.no_grad()
    def init(self, generator: torch.Generator):
        self.pre_norm.fill_(1.0)
        self.mixer.init(generator)
        if self.cfg.is_moe:
            self.moe.init(generator)
        elif self.cfg.d_ff > 0:
            self.mlp.init(generator)
        if hasattr(self, "mlp_norm"):
            self.mlp_norm.fill_(1.0)

    def forward(self, x, pos, cache=None):
        """Returns (x, aux); a decode `cache` is updated in place."""
        cfg = self.cfg
        h = L.rms_norm(x, self.pre_norm, cfg.norm_eps, plus_one=cfg.embed_scale)
        if self.kind in ("attn", "local"):
            window = cfg.local_window if self.kind == "local" else 0
            mix, _ = self.mixer(h, pos, cache=cache, window=window)
        else:
            mix, _ = self.mixer(h, cache=cache)
        # the residual stream stays whole on "model" in both passes: a
        # row-split projection's partial sums are reduced here, not
        # carried into the next column-split one, which would gather its
        # weight (a no-op without a mesh)
        x = x + constrain(mix, "batch", None, None)
        aux = torch.zeros((), dtype=F32, device=x.device)
        if cfg.is_moe or cfg.d_ff > 0:
            h = L.rms_norm(x, self.mlp_norm, cfg.norm_eps, plus_one=cfg.embed_scale)
            if cfg.is_moe:
                y, aux = self.moe(h)
            else:
                y = self.mlp(h)
            x = x + constrain(y, "batch", None, None)
        return x, aux

    def init_cache(self, batch: int, max_len: int):
        cfg, dtype, device = self.cfg, self.pre_norm.dtype, self.pre_norm.device
        if self.kind in ("attn", "local"):
            size = min(max_len, cfg.local_window) if self.kind == "local" else max_len
            G, hd = cfg.num_kv_heads, cfg.head_dim
            return {
                "k": torch.zeros((batch, size, G, hd), dtype=dtype, device=device),
                "v": torch.zeros((batch, size, G, hd), dtype=dtype, device=device),
                "pos": torch.full((batch, size), POS_SENTINEL, dtype=torch.int32,
                                  device=device),
                "index": 0,
            }
        if self.kind == "ssd":
            return S.ssd_init_cache(cfg, batch, dtype, device)
        return R.rglru_init_cache(cfg, batch, dtype, device)


class Model(nn.Module):
    def __init__(self, cfg: ArchConfig, device=None):
        super().__init__()
        device = resolve_device(device)
        dtype = DTYPES[cfg.dtype]
        self.cfg = cfg
        self.embed = L.param((cfg.vocab_size, cfg.d_model), dtype, device)
        self.final_norm = L.param((cfg.d_model,), dtype, device)
        if not cfg.tie_embeddings:
            self.lm_head = L.param((cfg.d_model, cfg.vocab_size), dtype, device)
        if cfg.frontend != "none":
            self.frontend_proj = L.param((cfg.frontend_dim, cfg.d_model), dtype, device)
        self.layers = nn.ModuleList(Layer(cfg, cfg.pattern_at(i), dtype, device)
                                    for i in range(cfg.num_layers))

    @property
    def device(self) -> torch.device:
        return self.embed.device

    # ---- init -------------------------------------------------------------
    @torch.no_grad()
    def init(self, generator: torch.Generator) -> "Model":
        """Fill every parameter from `generator` (on the model's device),
        with the reference's distributions."""
        cfg = self.cfg
        L.normal_init_(self.embed, generator, 0.02)
        self.final_norm.fill_(1.0)
        if not cfg.tie_embeddings:
            L.normal_init_(self.lm_head, generator, 1.0 / math.sqrt(cfg.d_model))
        if cfg.frontend != "none":
            L.dense_init_(self.frontend_proj, generator)
        for layer in self.layers:
            layer.init(generator)
        return self

    def reference_leaf(self, name: str) -> str:
        """The leaf of the reference's param pytree that holds parameter
        `name`: a scanned layer's tensors stack on the macro-block axis
        into one leaf, "blocks.l<i % period>.<rest>"; any other parameter
        is a leaf of its own.  The reference's optimizer and gradient
        compression work leaf by leaf, so the port groups by this."""
        if name.startswith("layers."):
            _, i, rest = name.split(".", 2)
            period = len(self.cfg.layer_pattern)
            if int(i) < self.cfg.num_layers // period * period:
                return f"blocks.l{int(i) % period}.{rest}"
        return name

    def decay_mask(self) -> dict:
        """{parameter name: whether AdamW decays it}, as the reference
        decides: it decays every leaf with two or more dimensions, and a
        scanned layer's leaf carries the macro-block axis, so a scanned
        layer's norm scales and biases are decayed and those of the tail
        layers and the top level are not."""
        return {name: p.ndim + (self.reference_leaf(name) != name) >= 2
                for name, p in self.named_parameters()}

    # ---- embedding / unembedding -------------------------------------------
    def _embed(self, tokens, frontend=None):
        cfg = self.cfg
        x = constrain(take_rows(self.embed, tokens), "batch", None, None)
        if cfg.embed_scale:
            x = x * torch.sqrt(torch.tensor(float(cfg.d_model), dtype=F32)).to(x.dtype)
        if frontend is not None and cfg.frontend != "none":
            dt = torch.promote_types(frontend.dtype, self.frontend_proj.dtype)
            fe = replicated_like(frontend, x).to(dt) @ self.frontend_proj.to(dt)
            x = torch.cat([fe.to(x.dtype), x[:, fe.shape[1]:]], dim=1)
        return x

    def head(self) -> torch.Tensor:
        """The (d, V) unembedding: the embedding's transpose when tied."""
        return self.embed.T if self.cfg.tie_embeddings else self.lm_head

    # ---- forward -----------------------------------------------------------
    def forward(self, tokens, frontend=None, *, remat: bool = False,
                remat_policy: str = "full"):
        """tokens (B, S) -> final hidden (B, S, d), plus the MoE aux loss.

        remat: each layer runs under `torch.utils.checkpoint`, so the
        backward pass recomputes its activations.  remat_policy "full"
        recomputes everything (least memory); "dots" keeps the outputs of
        the matmuls without batch dimensions, as the reference's policy
        does.  Serving calls this without remat; `loss` with it, as the
        reference's `loss` does."""
        cfg = self.cfg
        B, Sq = tokens.shape
        pos = torch.arange(Sq, dtype=torch.int32, device=tokens.device)[None].expand(B, Sq)
        x = self._embed(tokens, frontend)
        aux = torch.zeros((), dtype=F32, device=x.device)
        if remat_policy not in ("full", "dots"):
            raise ValueError(f"remat_policy {remat_policy!r}: 'full' or 'dots'")
        kw = ({"context_fn": functools.partial(create_selective_checkpoint_contexts,
                                               _save_dots)}
              if remat_policy == "dots" else {})
        for layer in self.layers:
            x, a = (checkpoint(layer, x, pos, use_reentrant=False, **kw) if remat
                    else layer(x, pos))
            aux = aux + a
        x = L.rms_norm(x, self.final_norm, cfg.norm_eps, plus_one=cfg.embed_scale)
        return x, aux

    # ---- loss (chunked CE over the head) -------------------------------------
    def loss(self, batch: dict, *, loss_chunk: int = 512, aux_weight: float = 0.01):
        """batch: {"tokens": (B, S) int, "labels": (B, S) int, optional
        "frontend"}.  The forward runs with remat; the sequence is cut
        into chunks of `loss_chunk` positions whose logits the backward
        pass recomputes, so (B, S, V) is never held.  Returns the mean
        token cross-entropy plus `aux_weight` times the MoE aux loss."""
        labels = batch["labels"]
        h, aux = self.forward(batch["tokens"], batch.get("frontend"), remat=True)
        head = self.head()
        B, Sq, _ = h.shape
        C = min(loss_chunk, Sq)
        if Sq % C:
            raise ValueError(f"loss_chunk {C} does not divide the sequence's {Sq}")
        sums = [checkpoint(_chunk_loss, h[:, i:i + C], labels[:, i:i + C], head,
                           use_reentrant=False)
                for i in range(0, Sq, C)]
        return torch.sum(torch.stack(sums)) / (B * Sq) + aux_weight * aux

    # ---- decode -------------------------------------------------------------
    def init_cache(self, batch: int, max_len: int) -> list:
        return [layer.init_cache(batch, max_len) for layer in self.layers]

    @torch.no_grad()
    def decode_step(self, cache: list, tokens, pos):
        """One decode step.  tokens (B, 1) int; pos (B, 1) int32 absolute.

        Writes `cache` in place (where the reference donates it) and
        returns (logits (B, V) f32, cache)."""
        x = self._embed(tokens)
        for layer, c in zip(self.layers, cache):
            x, _ = layer(x, pos, cache=c)
        x = L.rms_norm(x, self.final_norm, self.cfg.norm_eps,
                       plus_one=self.cfg.embed_scale)
        logits = x[:, -1].to(F32) @ self.head().to(F32)
        return logits, cache


def build(cfg: ArchConfig, device=None) -> Model:
    """A `Model` of `cfg` on `device` (the card by default), parameters
    uninitialised: call `init(generator)` or load them
    (`repro_torch.interop.lm_params_from_numpy`)."""
    return Model(cfg, device)
