"""Composable LM builder for the assigned architecture pool: the port of
`repro.models.model`.

`build(cfg, device)` returns a `Model` (an `nn.Module`) whose parameters
are allocated on the device but not yet initialised:

    init(generator)                   -> the model, initialised in place
    forward(tokens, frontend)         -> ((B, S, d) final hidden, MoE aux)
    init_cache(batch, max_len)        -> decode cache (one dict per layer)
    decode_step(cache, tokens, pos)   -> (logits, cache), cache written in place

Layers are one flat `ModuleList`: the reference's ``L // period``
macro-blocks of ``period = len(cfg.layer_pattern)`` layers (its scanned,
stacked params), then the ``L % period`` tail.  Every sub-layer is
pre-norm residual; MoE configs replace the dense MLP.  `Model.loss`
(chunked cross-entropy) belongs to the training path, not ported here.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models import rglru as R
from repro_torch.models import ssd as S

F32 = torch.float32
POS_SENTINEL = 1 << 30  # unwritten KV slots: fails the causal mask
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


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
        x = x + mix
        aux = torch.zeros((), dtype=F32, device=x.device)
        if cfg.is_moe or cfg.d_ff > 0:
            h = L.rms_norm(x, self.mlp_norm, cfg.norm_eps, plus_one=cfg.embed_scale)
            if cfg.is_moe:
                y, aux = self.moe(h)
            else:
                y = self.mlp(h)
            x = x + y
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

    # ---- embedding / unembedding -------------------------------------------
    def _embed(self, tokens, frontend=None):
        cfg = self.cfg
        x = self.embed[tokens.long()]
        if cfg.embed_scale:
            x = x * torch.sqrt(torch.tensor(float(cfg.d_model), dtype=F32)).to(x.dtype)
        if frontend is not None and cfg.frontend != "none":
            dt = torch.promote_types(frontend.dtype, self.frontend_proj.dtype)
            fe = frontend.to(dt) @ self.frontend_proj.to(dt)
            x = torch.cat([fe.to(x.dtype), x[:, fe.shape[1]:]], dim=1)
        return x

    def head(self) -> torch.Tensor:
        """The (d, V) unembedding: the embedding's transpose when tied."""
        return self.embed.T if self.cfg.tie_embeddings else self.lm_head

    # ---- forward -----------------------------------------------------------
    def forward(self, tokens, frontend=None):
        """tokens (B, S) -> final hidden (B, S, d), plus the MoE aux loss."""
        cfg = self.cfg
        B, Sq = tokens.shape
        pos = torch.arange(Sq, dtype=torch.int32, device=tokens.device)[None].expand(B, Sq)
        x = self._embed(tokens, frontend)
        aux = torch.zeros((), dtype=F32, device=x.device)
        for layer in self.layers:
            x, a = layer(x, pos)
            aux = aux + a
        x = L.rms_norm(x, self.final_norm, cfg.norm_eps, plus_one=cfg.embed_scale)
        return x, aux

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
