"""Int8 gradient compression with error feedback (1-bit-Adam-style EF):
the port of `repro.runtime.compress`.

Across data-parallel workers the gradient all-reduce dominates a step
for small per-device batches.  Compressing gradients to int8 with
per-tensor scales cuts the collective's bytes 4x (vs f32) / 2x (vs
bf16); the quantization residual is carried in an error-feedback buffer
so the SGD direction stays unbiased over time (Karimireddy et al. 2019).
On one card there is no collective: `roundtrip` runs compress and
decompress in place of it, as the reference's does.

    comp = Int8Compressor()
    ef = comp.init(params)                  # {name: f32 zeros}
    grads_q, ef = comp.roundtrip(grads, ef)
"""
from __future__ import annotations

import dataclasses

import torch

F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class Int8Compressor:
    clip_sigma: float = 4.0     # scale = clip_sigma * rms

    def init(self, params: dict) -> dict:
        """{name: f32 zeros} in each parameter's device and placements."""
        return {n: torch.zeros_like(p, dtype=F32) for n, p in params.items()}

    def compress(self, g: torch.Tensor, ef: torch.Tensor):
        """-> (q int8, scale f32 scalar, new residual).  Rounds half to
        even, as `jnp.round` does."""
        (q,), scale, (err,) = self._compress_group([g], [ef])
        return q, scale, err

    def _compress_group(self, gs: list, efs: list):
        """Tensors that share one scale: the rms of all their elements."""
        xs = [g.to(F32) + e for g, e in zip(gs, efs)]
        if len(xs) == 1:
            ms = torch.mean(torch.square(xs[0]))
        else:
            ms = (torch.sum(torch.stack([torch.sum(torch.square(x)) for x in xs]))
                  / sum(x.numel() for x in xs))
        rms = torch.sqrt(ms + 1e-12)
        scale = self.clip_sigma * rms / 127.0
        qs = [torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8) for x in xs]
        return qs, scale, [x - q.to(F32) * scale for x, q in zip(xs, qs)]

    @torch.no_grad()
    def roundtrip(self, grads: dict, ef_state: dict, groups: dict | None = None):
        """Compress + decompress every gradient, updating error feedback.

        groups: {name: key}; the tensors of one key share one scale.  The
        reference scales each leaf of its param pytree, where a scanned
        layer's tensors stack into one leaf (`Model.reference_leaf` gives
        the grouping); by default every tensor has its own scale.
        Returns (decompressed grads in each gradient's dtype, new ef_state)."""
        members: dict = {}
        for name in grads:
            members.setdefault(name if groups is None else groups[name], []).append(name)
        outs, errs = {}, {}
        for names in members.values():
            qs, scale, es = self._compress_group([grads[n] for n in names],
                                                 [ef_state[n] for n in names])
            for n, q, e in zip(names, qs, es):
                outs[n] = (q.to(F32) * scale).to(grads[n].dtype)
                errs[n] = e
        return outs, errs
