"""RG-LRU recurrent block (Griffin / RecurrentGemma, arXiv:2402.19427):
the port of `repro.models.rglru`.

The recurrent sub-layer is:  x -> [linear branch (gate), recurrent branch]
  recurrent branch: temporal conv1d(width 4) -> RG-LRU -> out
  RG-LRU:  r_t = sigmoid(W_a x_t + b_a)       (recurrence gate)
           i_t = sigmoid(W_x x_t + b_x)       (input gate)
           a_t = a^(c * r_t),  a = sigmoid(Lambda)  (per-channel, c=8)
           h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

A whole sequence runs a log-depth scan over (a, b) pairs (PyTorch has no
associative scan; the reference's `lax.associative_scan` combines in
another order, so the two agree to f32 rounding); decode is the one-step
recurrence.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.models.layers import normal_init_, param

F32 = torch.float32
_C = 8.0  # Griffin's recurrence-gate exponent constant


def _conv1d(x, w, b, state=None):
    K = w.shape[0]
    pad = (torch.zeros(x.shape[:-2] + (K - 1, x.shape[-1]), dtype=x.dtype, device=x.device)
           if state is None else state)
    xp = torch.cat([pad, x], dim=-2)
    out = sum(xp[..., i:i + x.shape[-2], :] * w[i] for i in range(K)) + b
    return out, xp[..., -(K - 1):, :]


def rglru_scan(x, a_log, gate_r, gate_i, h0=None):
    """x: (B, T, D) f32; a_log = c*r_t*log(a) (B,T,D) negative log-decay.

    Inclusive scan of h_t = a_t h_{t-1} + b_t by doubling (Hillis-Steele):
    ceil(log2 T) steps, each combining every element with the one `shift`
    before it."""
    a = torch.exp(a_log)
    b = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * a_log), min=1e-12)) * (gate_i * x)
    if h0 is not None:
        b = torch.cat([b[:, :1] + a[:, :1] * h0[:, None], b[:, 1:]], dim=1)
    T = x.shape[1]
    shift = 1
    while shift < T:
        b = torch.cat([b[:, :shift], a[:, shift:] * b[:, :-shift] + b[:, shift:]], dim=1)
        a = torch.cat([a[:, :shift], a[:, shift:] * a[:, :-shift]], dim=1)
        shift *= 2
    return b


class RgLru(nn.Module):
    """`RgLruParams` + `rglru_block`: the Griffin recurrent sub-layer."""

    def __init__(self, cfg: ArchConfig, dtype, device):
        super().__init__()
        d = cfg.d_model
        di = cfg.rglru_width or d
        self.cfg = cfg
        self.w_in = param((d, di), dtype, device)
        self.w_gate = param((d, di), dtype, device)
        self.w_out = param((di, d), dtype, device)
        self.conv_w = param((4, di), dtype, device)
        self.conv_b = param((di,), dtype, device)
        self.gate_a = param((di, di), dtype, device)
        self.gate_x = param((di, di), dtype, device)
        self.b_a = param((di,), F32, device)
        self.b_x = param((di,), F32, device)
        self.Lambda = param((di,), F32, device)

    @torch.no_grad()
    def init(self, generator: torch.Generator):
        d, di = self.w_in.shape
        normal_init_(self.w_in, generator, 1.0 / math.sqrt(d))
        normal_init_(self.w_gate, generator, 1.0 / math.sqrt(d))
        normal_init_(self.w_out, generator, 1.0 / math.sqrt(di))
        normal_init_(self.conv_w, generator, 0.2)
        self.conv_b.zero_()
        normal_init_(self.gate_a, generator, 1.0 / math.sqrt(di))
        normal_init_(self.gate_x, generator, 1.0 / math.sqrt(di))
        self.b_a.zero_()
        self.b_x.zero_()
        # Lambda so that a lies in [0.9, 0.999] (Griffin appendix)
        u = torch.empty((di,), dtype=F32, device=self.Lambda.device)
        u.uniform_(0.9 ** 2, 0.999 ** 2, generator=generator)
        self.Lambda.copy_(torch.log(torch.sqrt(u) / (1 - torch.sqrt(u))))

    def forward(self, x, cache=None):
        """x: (B, T, d).  cache: None or {"conv": (B,3,D), "h": (B,D)} for
        decode, updated in place.  Returns (out, cache)."""
        gate = F.gelu(x @ self.w_gate, approximate="tanh")
        u = x @ self.w_in
        conv_state = None if cache is None else cache["conv"]
        u, new_conv = _conv1d(u, self.conv_w, self.conv_b, conv_state)

        uf = u.to(F32)
        r = torch.sigmoid(uf @ self.gate_a.to(F32) + self.b_a)
        i = torch.sigmoid(uf @ self.gate_x.to(F32) + self.b_x)
        log_a = -_C * r * F.softplus(self.Lambda)           # (B,T,D) <= 0

        if cache is None:
            h = rglru_scan(uf, log_a, r, i)
        else:
            hs, hprev = [], cache["h"]
            for t in range(uf.shape[1]):
                a_t = torch.exp(log_a[:, t])
                hprev = a_t * hprev + torch.sqrt(
                    torch.clamp(1 - a_t ** 2, min=1e-12)) * (i[:, t] * uf[:, t])
                hs.append(hprev)
            h = torch.stack(hs, dim=1)
            cache["conv"].copy_(new_conv)
            cache["h"].copy_(hprev)

        return (h.to(x.dtype) * gate) @ self.w_out, cache


def rglru_init_cache(cfg: ArchConfig, batch: int, dtype, device):
    di = cfg.rglru_width or cfg.d_model
    return {
        "conv": torch.zeros((batch, 3, di), dtype=dtype, device=device),
        "h": torch.zeros((batch, di), dtype=F32, device=device),
    }
