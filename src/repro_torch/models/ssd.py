"""Mamba-2 SSD (state-space duality) mixer: the port of `repro.models.ssd`.

Per-head scalar decay a_t = exp(-softplus(dt) * A), matrix state
H in R^{P x S} (arXiv:2405.21060):

    H_t = a_t * H_{t-1} + dt_t * x_t b_t^T
    y_t = H_t c_t + D * x_t

A whole sequence uses the chunked (block) form: an intra-chunk
attention-like term plus a recurrence over chunk states.  Decode is the
one-step recurrence over a carried state.
"""
from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.launch.mesh import axis_sizes
from repro_torch.models.layers import normal_init_, param
from repro_torch.models.sharding import (constrain, is_dtensor, local_shards, merge_heads,
                                         replicated_like, split_heads)

F32 = torch.float32


def _split(pre, di, S, nh):
    z = pre[..., :di]
    xBC = pre[..., di:di + di + 2 * S]
    dt = pre[..., -nh:]
    return z, xBC, dt


def _causal_conv(xBC, w, b, state=None):
    """Depthwise causal conv width K over (B, T, C); state (B, K-1, C)."""
    K = w.shape[0]
    if state is None:
        pad = replicated_like(torch.zeros(xBC.shape[:-2] + (K - 1, xBC.shape[-1]),
                                          dtype=xBC.dtype, device=xBC.device), xBC)
    else:
        pad = state
    xp = torch.cat([pad, xBC], dim=-2)                      # (B, T+K-1, C)
    out = sum(xp[..., i:i + xBC.shape[-2], :] * w[i] for i in range(K)) + b
    new_state = xp[..., -(K - 1):, :]
    return F.silu(out), new_state


def ssd_chunked(x, dt, a_log, B, C, D, chunk: int):
    """Chunked SSD scan.

    x: (Bt, T, nh, P)   dt: (Bt, T, nh)  softplus-ed already
    B, C: (Bt, T, S)    (single group, broadcast over heads)
    Returns (y (Bt, T, nh, P), the final state (Bt, nh, S, P)).
    On DTensors the scan runs shard by shard (`sharding.local_shards`):
    the batch over the data axes and the heads over "model" where they
    divide, B and C whole on each shard (its einsums flatten (batch,
    heads), which DTensor's view rules refuse when both are sharded).
    """
    Bt, T, nh, P = x.shape
    if T % chunk:
        raise ValueError(f"chunk {chunk} does not divide {T}")
    A = -torch.exp(a_log)                                   # (nh,) negative
    dA = dt * A                                             # (Bt, T, nh) log-decay
    tp = axis_sizes(x.device_mesh).get("model", 1) if is_dtensor(x) else 1
    heads = "model" if nh % tp == 0 else None
    y, H = local_shards(functools.partial(_ssd_scan, chunk=chunk), (x, dt, dA, B, C),
                        (("batch", None, heads, None), ("batch", None, heads),
                         ("batch", None, heads), ("batch", None, None), ("batch", None, None)),
                        [(x.shape, ("batch", None, heads, None)),
                         ((Bt, nh, B.shape[-1], P), ("batch", heads, None, None))])
    return y + D[None, None, :, None] * x, H


def _ssd_scan(x, dt, dA, B, C, chunk: int):
    """`ssd_chunked` without its D skip term, from the log-decay dA."""
    Bt, T, nh, P = x.shape
    S = B.shape[-1]
    nc = T // chunk
    xr = x.reshape(Bt, nc, chunk, nh, P)
    dtr = dt.reshape(Bt, nc, chunk, nh)
    dAr = dA.reshape(Bt, nc, chunk, nh)
    Br = B.reshape(Bt, nc, chunk, S)
    Cr = C.reshape(Bt, nc, chunk, S)

    # cumulative log-decay within each chunk (inclusive)
    seg = torch.cumsum(dAr, dim=2)                          # (Bt, nc, chunk, nh)

    # 1) intra-chunk (dual "attention" form):
    #    y_t += sum_{s<=t} exp(seg_t - seg_s) * dt_s * (c_t . b_s) x_s
    rel = seg[:, :, :, None, :] - seg[:, :, None, :, :]     # (Bt,nc,t,s,nh)
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool, device=x.device))
    # mask the exponent, not the product: exp of the masked (s > t)
    # entries would overflow (rel > 0 there)
    rel = rel.masked_fill(~tri[None, None, :, :, None], -math.inf)
    decay = torch.exp(rel)
    scores = torch.einsum("bnti,bnui->bntu", Cr, Br)        # (Bt,nc,t,u)
    w = scores[..., None] * decay * dtr[:, :, None, :, :]   # (Bt,nc,t,u,nh)
    y_intra = torch.einsum("bntuh,bnuhp->bnthp", w, xr)

    # 2) chunk states: G_n = sum_s exp(seg_last - seg_s) dt_s b_s x_s^T
    last = seg[:, :, -1:, :]                                # (Bt,nc,1,nh)
    w_in = torch.exp(last - seg) * dtr                      # (Bt,nc,chunk,nh)
    G = torch.einsum("bnsh,bnsi,bnshp->bnhip", w_in, Br, xr)  # (Bt,nc,nh,S,P)

    # 3) inter-chunk recurrence over chunk states; each chunk reads the
    # state BEFORE it
    chunk_decay = torch.exp(last[:, :, 0, :])               # (Bt,nc,nh)
    H = torch.zeros((Bt, nh, S, P), dtype=x.dtype, device=x.device)
    H_prev = []
    for n in range(nc):
        H_prev.append(H)
        H = H * chunk_decay[:, n, :, None, None] + G[:, n]
    H_prev = torch.stack(H_prev, dim=1)                     # (Bt,nc,nh,S,P)

    # 4) inter-chunk contribution: y_t += exp(seg_t) * c_t . H_prev
    y_inter = torch.einsum("bnth,bnti,bnhip->bnthp", torch.exp(seg), Cr, H_prev)
    return (y_intra + y_inter).reshape(Bt, T, nh, P), H


class Ssd(nn.Module):
    """`SsdParams` + `ssd_block`: the Mamba-2 mixer sub-layer."""

    def __init__(self, cfg: ArchConfig, dtype, device):
        super().__init__()
        d = cfg.d_model
        di = cfg.ssm_expand * d          # inner width
        nh = di // cfg.ssm_head_dim      # heads
        S = cfg.ssm_state_dim
        self.cfg = cfg
        self.in_proj = param((d, 2 * di + 2 * S + nh), dtype, device)  # [z, x, B, C, dt]
        self.out_proj = param((di, d), dtype, device)
        # conv over [x, B, C] features, width 4 (mamba2 default)
        self.conv_w = param((4, di + 2 * S), dtype, device)
        self.conv_b = param((di + 2 * S,), dtype, device)
        self.A_log = param((nh,), F32, device)
        self.D = param((nh,), F32, device)
        self.dt_bias = param((nh,), F32, device)
        self.norm = param((di,), dtype, device)

    @torch.no_grad()
    def init(self, generator: torch.Generator):
        d = self.cfg.d_model
        di = self.out_proj.shape[0]
        normal_init_(self.in_proj, generator, 1.0 / math.sqrt(d))
        normal_init_(self.out_proj, generator, 1.0 / math.sqrt(di))
        normal_init_(self.conv_w, generator, 0.2)
        self.conv_b.zero_()
        nh = self.A_log.shape[0]
        self.A_log.copy_(torch.log(torch.linspace(1.0, 16.0, nh, dtype=F32)))
        self.D.fill_(1.0)
        self.dt_bias.fill_(math.log(math.e - 1))            # softplus^-1(1)
        self.norm.fill_(1.0)

    def forward(self, x, cache=None):
        """x: (B, T, d).  cache: None (a whole sequence) or {"conv": (B,3,C),
        "H": (B,nh,S,P)} for decode, updated in place.  Returns (out, cache)."""
        cfg = self.cfg
        Bt, T, d = x.shape
        di = cfg.ssm_expand * d
        S = cfg.ssm_state_dim
        P = cfg.ssm_head_dim
        nh = di // P
        pre = constrain(x @ self.in_proj, "batch", None, "model")
        z, xBC, dt = _split(pre, di, S, nh)
        dt = F.softplus(dt.to(F32) + self.dt_bias)

        conv_state = None if cache is None else cache["conv"]
        xBC, new_conv = _causal_conv(xBC, self.conv_w, self.conv_b, conv_state)
        xs = split_heads(xBC[..., :di], Bt, T, nh, P)
        B = xBC[..., di:di + S].to(F32)
        C = xBC[..., di + S:].to(F32)

        if cache is None:
            y, _ = ssd_chunked(xs.to(F32), dt, self.A_log, B, C, self.D,
                               min(cfg.ssm_chunk, T))
        else:
            # one-step recurrence, T steps in order (T == 1 in decode)
            A = -torch.exp(self.A_log)
            xf = xs.to(F32)
            H = cache["H"]
            ys = []
            for t in range(T):
                dec = torch.exp(dt[:, t] * A)               # (Bt,nh)
                H = H * dec[..., None, None] + torch.einsum(
                    "bh,bi,bhp->bhip", dt[:, t], B[:, t], xf[:, t])
                ys.append(torch.einsum("bi,bhip->bhp", C[:, t], H))
            y = torch.stack(ys, dim=1) + self.D[None, None, :, None] * xf
            cache["conv"].copy_(new_conv)
            cache["H"].copy_(H)

        y = merge_heads(y, Bt, T, di).to(x.dtype)
        # gated RMSNorm (mamba2): norm(y * silu(z))
        y = y * F.silu(z)
        var = torch.mean(torch.square(y.to(F32)), dim=-1, keepdim=True)
        y = (y.to(F32) * torch.rsqrt(var + cfg.norm_eps)).to(x.dtype) * self.norm
        return y @ self.out_proj, cache


def ssd_init_cache(cfg: ArchConfig, batch: int, dtype, device):
    d = cfg.d_model
    di = cfg.ssm_expand * d
    S = cfg.ssm_state_dim
    P = cfg.ssm_head_dim
    nh = di // P
    return {
        "conv": torch.zeros((batch, 3, di + 2 * S), dtype=dtype, device=device),
        "H": torch.zeros((batch, nh, S, P), dtype=F32, device=device),
    }
