"""AdamW with decoupled weight decay, f32 moments and a global-norm clip:
the port of `repro.optim.adamw`.

It works on named tensors: `params`, `grads` and the moments are dicts
from a parameter's name (`Model.named_parameters()`) to its tensor.  The
update is the reference's, term for term (the clip `clip_norm / (gnorm +
1e-12)`, bias correction at `t = step + 1`, `eps` outside the square
root, decay only on tensors of two or more dimensions, the new value
formed in f32 and cast back to the parameter's dtype), run as
`torch._foreach_*` ops over every tensor at once and written into the
parameters in place.  `torch.optim.AdamW` is not this update: it decays
before the moment step, corrects the bias in another order and has no
clip.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class AdamW:
    lr: Callable[[int], float] | float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0

    def init(self, params: dict) -> dict:
        return adamw_init(params)

    def update(self, params: dict, opt_state: dict, grads: dict, step: int, decay=None):
        return adamw_update(self, params, opt_state, grads, step, decay)


def adamw_init(params: dict) -> dict:
    """{"m": {name: zeros}, "v": {name: zeros}}, f32, on each parameter's
    device and, for a DTensor parameter, in its placements."""
    def zeros():
        return {n: torch.zeros_like(p, dtype=F32) for n, p in params.items()}
    return {"m": zeros(), "v": zeros()}


def _foreach_copy_(dst: list, src: list) -> None:
    """`torch._foreach_copy_`; DTensors copy shard by shard (each source
    has its destination's placements), since DTensor has no layout rule
    for the foreach copy on every PyTorch version."""
    from torch.distributed.tensor import DTensor
    if isinstance(dst[0], DTensor):
        dst, src = [t.to_local() for t in dst], [t.to_local() for t in src]
    torch._foreach_copy_(dst, src)


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares of every element, in f32."""
    norms = torch._foreach_norm([g.to(F32) for g in tensors])
    return torch.sqrt(torch.sum(torch.stack(norms) ** 2))


@torch.no_grad()
def adamw_update(opt: AdamW, params: dict, opt_state: dict, grads: dict, step: int,
                 decay: dict | None = None):
    """Update `params` in place from `grads` at `step` (0-based).

    decay: {name: bool}, which parameters take the weight decay; by
    default those with two or more dimensions.  `Model.decay_mask()`
    gives the reference's choice for a model's parameters.

    Returns (opt_state, metrics {"grad_norm", "lr"}): the state's moments
    are updated in place, and any other entry of it (the error-feedback
    buffer `ef`) is carried over as it is."""
    names = list(params)
    p = [params[n] for n in names]
    m = [opt_state["m"][n] for n in names]
    v = [opt_state["v"][n] for n in names]
    g = [grads[n].to(F32) for n in names]
    gnorm = global_norm(g)
    scale = torch.clamp(opt.clip_norm / (gnorm + 1e-12), max=1.0)
    g = torch._foreach_mul(g, scale)
    lr = np.float32(opt.lr(step) if callable(opt.lr) else opt.lr)
    t = np.float32(step + 1)
    bc1 = float(np.float32(1) - np.float32(opt.b1) ** t)
    bc2 = float(np.float32(1) - np.float32(opt.b2) ** t)

    torch._foreach_mul_(m, opt.b1)
    torch._foreach_add_(m, g, alpha=1 - opt.b1)
    torch._foreach_mul_(v, opt.b2)
    torch._foreach_addcmul_(v, g, g, value=1 - opt.b2)
    del g
    denom = torch._foreach_div(v, bc2)
    torch._foreach_sqrt_(denom)
    torch._foreach_add_(denom, opt.eps)
    delta = torch._foreach_div(m, bc1)
    torch._foreach_div_(delta, denom)
    del denom
    p32 = [x.to(F32) for x in p]          # the f32 parameters are themselves
    decayed = [i for i, (n, x) in enumerate(zip(names, p))
               if (x.ndim >= 2 if decay is None else decay[n])]
    if opt.weight_decay and decayed:
        torch._foreach_add_([delta[i] for i in decayed], [p32[i] for i in decayed],
                            alpha=opt.weight_decay)
    torch._foreach_add_(p32, delta, alpha=-float(lr))
    low = [i for i, x in enumerate(p) if x.dtype != F32]
    if low:
        _foreach_copy_([p[i] for i in low], [p32[i] for i in low])
    metrics = {"grad_norm": gnorm, "lr": torch.tensor(lr, dtype=F32)}
    return opt_state, metrics
