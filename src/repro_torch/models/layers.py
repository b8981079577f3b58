"""Shared transformer layers: norms, RoPE, streaming attention, MLP, MoE.

The port of `repro.models.layers`.  Parameter tensors keep the
reference's `x @ W` orientation and names, so its param pytree loads by
name (`repro_torch.interop.lm_params_from_numpy`).

Where the reference runs a bf16 einsum with f32 accumulation
(`preferred_element_type=F32`), the port casts both operands to f32:
products of bf16 values are exact in f32, so only the summation order
differs.

`sharding.constrain` sits where the reference's does: a no-op without a
mesh, a redistribution of a DTensor under `sharding.use_mesh`.
"""
from __future__ import annotations

import functools
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.models.sharding import (attention_shards, constrain, merge_heads, regroup,
                                         replicated_like, split_heads, topk)

F32 = torch.float32


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float,
             plus_one: bool = False) -> torch.Tensor:
    """RMSNorm: f32 statistics, elementwise in the residual dtype.

    The variance runs in f32 and `rsqrt` is cast back to `x.dtype`; the
    normalize/scale multiplies stay in that dtype, as in the reference."""
    dt = x.dtype
    xf = x.to(F32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    inv = torch.rsqrt(var + eps).to(dt)
    w = scale.to(F32)
    if plus_one:
        w = w + 1.0
    return x * inv * w.to(dt)


def rope(q: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding on (..., S, H, hd); pos (..., S) int.  Rotates the
    two halves of the head (not interleaved pairs), in f32."""
    hd = q.shape[-1]
    half = hd // 2
    freqs = theta ** (-torch.arange(0, half, dtype=F32, device=q.device) / half)
    ang = pos.to(F32)[..., None] * replicated_like(freqs, pos)   # (..., S, half)
    cos = replicated_like(torch.cos(ang)[..., None, :], q)       # (..., S, 1, half)
    sin = replicated_like(torch.sin(ang)[..., None, :], q)
    q1, q2 = q[..., :half].to(F32), q[..., half:].to(F32)
    out = torch.cat([q1 * cos - q2 * sin, q2 * cos + q1 * sin], dim=-1)
    return out.to(q.dtype)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    q_pos: torch.Tensor, kv_pos: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    kv_chunk: int = 1024, softmax_scale: Optional[float] = None
                    ) -> torch.Tensor:
    """Streaming (flash-style) attention with GQA and optional local window.

    q: (B, Sq, H, hd); k/v: (B, Skv, G, hd), H % G == 0.
    q_pos: (B, Sq) absolute positions; kv_pos: (B, Skv).
    Sq == 1 is the decode path: one grouped pass, no KV repeat.  Longer
    queries walk the KV in chunks with a running max and denominator.
    Rows with no valid key yet (unwritten cache slots carry a position
    sentinel past every query) give 0, not NaN.
    """
    B, Sq, H, hd = q.shape
    _, Skv, G, _ = k.shape
    rep = H // G
    scale = softmax_scale if softmax_scale is not None else 1.0 / math.sqrt(hd)

    if Sq == 1:
        qg = (q.to(F32) * scale).to(k.dtype).reshape(B, 1, G, rep, hd)
        qg = constrain(qg, "batch", None, None, None, "model")
        s = torch.einsum("bqgrh,bsgh->bgrqs", qg.to(F32), k.to(F32))
        s = constrain(s, "batch", None, None, None, None)
        mask = q_pos[:, :, None] >= kv_pos[:, None, :]      # (B,1,S)
        if window:
            mask &= q_pos[:, :, None] - kv_pos[:, None, :] < window
        mask = mask[:, None, None, :, :]
        s = s.masked_fill(~mask, -math.inf)
        m = torch.amax(s, dim=-1, keepdim=True)
        p = torch.exp(s - torch.where(torch.isfinite(m), m, 0.0))
        p = p.masked_fill(~mask, 0.0)
        l = torch.sum(p, dim=-1, keepdim=True)
        o = torch.einsum("bgrqs,bsgh->bqgrh",
                         (p / torch.clamp(l, min=1e-30)).to(k.dtype).to(F32), v.to(F32))
        return o.reshape(B, 1, H, hd).to(q.dtype)

    nk = max(1, Skv // kv_chunk)
    ck = Skv // nk
    if Skv % nk:
        raise ValueError(f"{Skv} keys do not split into {nk} chunks")

    # q scaled in f32 then cast to the KV dtype, as the reference does
    qf = constrain((q.to(F32) * scale).to(k.dtype).to(F32), "batch", None, "model", None)
    m = torch.full((B, H, Sq), -math.inf, dtype=F32, device=q.device)
    l = torch.zeros((B, H, Sq), dtype=F32, device=q.device)
    o = torch.zeros((B, H, Sq, hd), dtype=F32, device=q.device)
    for j in range(nk):
        kj, vj = k[:, j * ck:(j + 1) * ck], v[:, j * ck:(j + 1) * ck]
        pj = kv_pos[:, j * ck:(j + 1) * ck]
        if rep > 1:
            kj = torch.repeat_interleave(kj, rep, dim=2)     # (B,ck,H,hd)
            vj = torch.repeat_interleave(vj, rep, dim=2)
        kj = constrain(kj, "batch", None, "model", None)
        vj = constrain(vj, "batch", None, "model", None)
        s = torch.einsum("bshd,bchd->bhsc", qf, kj.to(F32))
        mask = torch.ones((B, Sq, ck), dtype=torch.bool, device=q.device)
        if causal:
            mask &= q_pos[:, :, None] >= pj[:, None, :]
        if window:
            mask &= q_pos[:, :, None] - pj[:, None, :] < window
        mask = mask[:, None, :, :]
        s = s.masked_fill(~mask, -math.inf)
        m_new = torch.maximum(m, torch.amax(s, dim=-1))
        m_safe = torch.where(torch.isfinite(m_new), m_new, 0.0)
        p = torch.exp(s - m_safe[..., None])
        p = p.masked_fill(~mask, 0.0)
        corr = torch.where(torch.isfinite(m), torch.exp(m - m_safe), 0.0)
        l = l * corr + torch.sum(p, dim=-1)
        o = o * corr[..., None] + torch.einsum(
            "bhsc,bchd->bhsd", p.to(k.dtype).to(F32), vj.to(F32))
        m = m_new
    o = o / torch.clamp(l, min=1e-30)[..., None]
    return o.movedim(1, 2).to(q.dtype)                      # (B,Sq,H,hd)


# --- parameter helpers --------------------------------------------------------

def param(shape, dtype, device) -> nn.Parameter:
    """An uninitialised parameter; `init(generator)` or the interop fills it."""
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device))


def dense_init_(p: torch.Tensor, generator: torch.Generator, in_axis: int = 0):
    """Fill `p` in place: a standard normal truncated to [-2, 2], drawn in
    f32, times 1/sqrt(fan_in), cast to `p`'s dtype."""
    std = 1.0 / math.sqrt(p.shape[in_axis])
    t = torch.empty(p.shape, dtype=F32, device=p.device)
    nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=generator)
    p.copy_(t * std)


def normal_init_(p: torch.Tensor, generator: torch.Generator, std: float):
    """Fill `p` in place: a normal drawn in f32 times `std`."""
    t = torch.empty(p.shape, dtype=F32, device=p.device)
    t.normal_(generator=generator)
    p.copy_(t * std)


class Attention(nn.Module):
    """`AttnParams` + `attention_block`: the self-attention sub-layer."""

    def __init__(self, cfg: ArchConfig, dtype, device):
        super().__init__()
        d, H, G, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
        self.cfg = cfg
        self.wq = param((d, H * hd), dtype, device)
        self.wk = param((d, G * hd), dtype, device)
        self.wv = param((d, G * hd), dtype, device)
        self.wo = param((H * hd, d), dtype, device)
        if cfg.qk_norm:
            self.q_norm = param((hd,), dtype, device)
            self.k_norm = param((hd,), dtype, device)

    @torch.no_grad()
    def init(self, generator: torch.Generator):
        for w in (self.wq, self.wk, self.wv, self.wo):
            dense_init_(w, generator)
        if self.cfg.qk_norm:
            self.q_norm.fill_(1.0)
            self.k_norm.fill_(1.0)

    def forward(self, x, pos, cache=None, window: int = 0):
        """x (B, Sq, d), pos (B, Sq).  cache: None (causal over x itself) or
        {"k","v": (B, S_cache, G, hd), "pos": (B, S_cache), "index": int}
        for decode, written in place (a local layer's cache is a ring
        buffer at index % S_cache).  Returns (out, cache)."""
        cfg = self.cfg
        B, Sq, d = x.shape
        H, G, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
        q = split_heads(x @ self.wq, B, Sq, H, hd)
        k = split_heads(x @ self.wk, B, Sq, G, hd)
        v = split_heads(x @ self.wv, B, Sq, G, hd)
        if cfg.qk_norm:
            q = rms_norm(q, self.q_norm, cfg.norm_eps)
            k = rms_norm(k, self.k_norm, cfg.norm_eps)
        q = rope(q, pos, cfg.rope_theta)
        k = rope(k, pos, cfg.rope_theta)

        attend = functools.partial(flash_attention, causal=True, window=window)
        if cache is None:
            o = attention_shards(attend, q, k, v, pos, pos)
        else:
            idx = cache["index"]
            S_cache = cache["k"].shape[1]
            slot = idx % S_cache if window else idx
            if slot + Sq > S_cache:
                raise ValueError(f"decode cache of {S_cache} slots is full at {idx}")
            cache["k"][:, slot:slot + Sq] = k
            cache["v"][:, slot:slot + Sq] = v
            cache["pos"][:, slot:slot + Sq] = pos
            cache["index"] = idx + Sq
            o = attention_shards(attend, q, cache["k"], cache["v"], pos, cache["pos"])
        return constrain(merge_heads(o, B, Sq, H * hd) @ self.wo, "batch", None, None), cache


def _act(name: str):
    return {"silu": F.silu, "gelu": lambda x: F.gelu(x, approximate="tanh")}[name]


class Mlp(nn.Module):
    """`MlpParams` + `mlp_block` (gated or plain).  Also the MoE's shared
    experts, which are always gated."""

    def __init__(self, d: int, ff: int, gated: bool, act: str, dtype, device):
        super().__init__()
        self.act = act
        self.w_in = param((d, ff), dtype, device)
        self.w_out = param((ff, d), dtype, device)
        self.w_gate = param((d, ff), dtype, device) if gated else None

    @torch.no_grad()
    def init(self, generator: torch.Generator):
        dense_init_(self.w_in, generator)
        dense_init_(self.w_out, generator)
        if self.w_gate is not None:
            dense_init_(self.w_gate, generator)

    def forward(self, x):
        h = constrain(x @ self.w_in, "batch", None, "model")
        if self.w_gate is not None:
            h = _act(self.act)(constrain(x @ self.w_gate, "batch", None, "model")) * h
        else:
            h = _act(self.act)(h)
        return constrain(h @ self.w_out, "batch", None, None)


def _one_hot(idx: torch.Tensor, n: int, dtype) -> torch.Tensor:
    """`jax.nn.one_hot`: an index outside [0, n) gives a row of zeros."""
    return (idx[..., None] == replicated_like(torch.arange(n, device=idx.device), idx)).to(dtype)


def _by_expert(x: torch.Tensor) -> torch.Tensor:
    """(G, E, C, k) -> contiguous (E, G*C, k)."""
    g, e, c, k = x.shape
    # a clone, not `contiguous()`: a DTensor may call itself contiguous while
    # its local shard is not
    return torch.clone(x.transpose(0, 1), memory_format=torch.contiguous_format
                       ).reshape(e, g * c, k)


def _by_group(y: torch.Tensor, g: int) -> torch.Tensor:
    """(E, G*C, k) -> (G, E, C, k)."""
    e, gc, k = y.shape
    return y.reshape(e, g, gc // g, k).transpose(0, 1)


class _ExpertMM(torch.autograd.Function):
    """einsum("gecd,edf->gecf", x, w) as batched matmuls over the experts,
    forward and backward, on contiguous operands: a DTensor's einsum
    backward views its permuted local shards, which fails once the
    groups are split."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return _by_group(torch.matmul(_by_expert(x), w), x.shape[0])

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        dy_e = _by_expert(dy)                                   # (E, G*C, F)
        dx = _by_group(torch.matmul(dy_e, w.transpose(1, 2)), x.shape[0])
        dw = torch.matmul(_by_expert(x).transpose(1, 2), dy_e)  # (E, D, F)
        return dx, dw


class Moe(nn.Module):
    """`MoeParams` + `moe_block`: top-k routed experts with grouped
    capacity dispatch (einsum or gather), plus always-on shared experts."""

    def __init__(self, cfg: ArchConfig, dtype, device):
        super().__init__()
        d, E, ff = cfg.d_model, cfg.moe_num_experts, cfg.moe_d_ff
        self.cfg = cfg
        self.router = param((d, E), F32, device)            # router kept in f32
        self.w_in = param((E, d, ff), dtype, device)
        self.w_gate = param((E, d, ff), dtype, device)
        self.w_out = param((E, ff, d), dtype, device)
        self.shared = (Mlp(d, ff * cfg.moe_num_shared, True, cfg.act, dtype, device)
                       if cfg.moe_num_shared else None)

    @torch.no_grad()
    def init(self, generator: torch.Generator):
        dense_init_(self.router, generator)
        for w in (self.w_in, self.w_gate, self.w_out):
            dense_init_(w, generator, in_axis=1)
        if self.shared is not None:
            self.shared.init(generator)

    def forward(self, x, *, capacity_factor: float = 0.0, group_size: int = 2048):
        """x: (B, S, d).  Returns (out, aux_loss)."""
        cfg = self.cfg
        B, S, d = x.shape
        E, K = cfg.moe_num_experts, cfg.moe_top_k
        capacity_factor = capacity_factor or cfg.moe_capacity_factor
        T = B * S
        G = min(group_size, T)
        nG = T // G
        if T % G:
            raise ValueError(f"{T} tokens do not split into groups of {G}")
        xt = constrain(regroup(x, nG, G, d), "batch", None, None)

        logits = xt.to(F32) @ self.router                   # (nG, G, E)
        probs = torch.softmax(logits, dim=-1)
        gate_vals, idx = topk(probs, K)                     # (nG, G, K)
        gate_vals = gate_vals / torch.sum(gate_vals, dim=-1, keepdim=True)

        C = int(math.ceil(G * K / E * capacity_factor))
        C = min(max(C, 4), G)
        onehot = _one_hot(idx, E, F32)                      # (nG, G, K, E)
        # position of each (token, k) within its expert queue (group-local)
        flat = onehot.reshape(nG, G * K, E)
        ranks = (torch.cumsum(flat, dim=1) - flat).reshape(nG, G, K, E)
        keep = (ranks < C) * onehot
        pos = torch.einsum("gtke,gtke->gtk", ranks, onehot).to(torch.int64)
        act = _act(cfg.act)

        if cfg.moe_dispatch == "gather":
            kept = torch.einsum("gtke->gtk", keep) > 0      # (nG, G, K)
            slot = torch.where(kept, idx * C + pos, E * C)  # E*C: drop bucket
            upd = torch.repeat_interleave(xt, K, dim=1)     # (nG, G*K, d)
            xe = constrain(replicated_like(torch.zeros((nG, E * C + 1, d), dtype=x.dtype,
                                                       device=x.device), xt),
                           "batch", None, None)
            xe.scatter_add_(1, slot.reshape(nG, G * K, 1).expand(-1, -1, d), upd)
            xe = constrain(xe[:, :-1].reshape(nG, E, C, d), "batch", None, None, None)
            h = constrain(_ExpertMM.apply(xe, self.w_in),
                          "batch", None, None, "model")
            g = act(_ExpertMM.apply(xe, self.w_gate))
            ye = _ExpertMM.apply(h * g, self.w_out)
            ye_flat = ye.reshape(nG, E * C, d)
            back = torch.gather(
                ye_flat, 1,
                torch.clamp(slot, max=E * C - 1).reshape(nG, G * K, 1).expand(-1, -1, d)
            ).reshape(nG, G, K, d)
            w = (gate_vals * kept).to(back.dtype)           # (nG, G, K)
            out = torch.einsum("gtk,gtkd->gtd", w, back)
        else:
            posoh = _one_hot(pos, C, x.dtype)               # (nG, G, K, C)
            disp = torch.einsum("gtke,gtkc->gtec", keep.to(x.dtype), posoh)
            comb = torch.einsum("gtec,gtk,gtke->gtec",
                                disp.to(F32), gate_vals, keep).to(x.dtype)
            xe = constrain(torch.einsum("gtec,gtd->gecd", disp, xt),   # (nG, E, C, d)
                           "batch", None, None, None)
            h = constrain(_ExpertMM.apply(xe, self.w_in),
                          "batch", None, None, "model")
            g = act(_ExpertMM.apply(xe, self.w_gate))
            ye = _ExpertMM.apply(h * g, self.w_out)
            out = torch.einsum("gtec,gecd->gtd", comb, ye)

        if self.shared is not None:
            out = out + self.shared(xt)

        # load-balance aux loss (Switch-style)
        density = torch.mean(onehot.sum(2), dim=(0, 1))     # routed frac / e
        router_prob = torch.mean(probs, dim=(0, 1))
        aux = torch.sum(density * router_prob) * E
        return regroup(out, B, S, d), aux
