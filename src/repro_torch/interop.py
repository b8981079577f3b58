"""Carry key material, ciphertexts, radix integers and LM weights across
from numpy, and LM weights (or gradients, moments) back.

The reference keeps torus values as uint64; the port carries the same
bits as int64 (`ndarray.view(np.int64)`).  These helpers import no JAX:
a caller hands over `np.asarray(...)` of the reference's arrays.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.integer import RadixCiphertext, RadixSpec
from repro_torch.core.params import TFHEParams
from repro_torch.core.pbs import TFHEContext
from repro_torch.device import resolve_device


def u64_to_tensor(a, device=None) -> torch.Tensor:
    """uint64 array -> int64 tensor with the same bits."""
    a = np.ascontiguousarray(np.asarray(a, dtype=np.uint64))
    return torch.tensor(a.view(np.int64), device=resolve_device(device))


def tensor_to_u64(t: torch.Tensor) -> np.ndarray:
    """int64 tensor -> uint64 array with the same bits."""
    return t.detach().cpu().contiguous().numpy().view(np.uint64)


def context_from_numpy(params_fields: dict, arrays: dict, device=None) -> TFHEContext:
    """Build a port `TFHEContext` from a reference context's fields.

    params_fields: `dataclasses.asdict(ctx.params)`.
    arrays: numpy `lwe_sk`, `glwe_sk`, `big_sk`, `ksk` (uint64) and
    `bsk_f` (complex128).
    """
    device = resolve_device(device)
    keys = {name: u64_to_tensor(arrays[name], device)
            for name in ("lwe_sk", "glwe_sk", "big_sk", "ksk")}
    bsk_f = torch.tensor(np.asarray(arrays["bsk_f"], dtype=np.complex128),
                         device=device)
    return TFHEContext(TFHEParams(**params_fields), bsk_f=bsk_f, **keys)


def radix_from_numpy(spec_fields: dict, digits, device=None):
    """Build a port `RadixCiphertext` from a reference one's fields.

    spec_fields: `dataclasses.asdict(rct.spec)` — `params` (a dict of
    `TFHEParams` fields), `bits` and `msg_bits`.  digits: the (D, k*N+1)
    uint64 digit ciphertexts."""
    spec = RadixSpec(TFHEParams(**spec_fields["params"]), spec_fields["bits"],
                     spec_fields["msg_bits"])
    spec.validate()
    return RadixCiphertext(spec, u64_to_tensor(digits, device))


def radix_to_numpy(rct: RadixCiphertext) -> tuple[dict, np.ndarray]:
    """The inverse of `radix_from_numpy`: (spec fields, uint64 digits)."""
    return dataclasses.asdict(rct.spec), tensor_to_u64(rct.digits)


def _lm_tensor(a) -> torch.Tensor:
    """A numpy array as a CPU tensor; bfloat16 (ml_dtypes) by its bits."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.tensor(a.view(np.int16)).view(torch.bfloat16)
    return torch.tensor(a)


def _lm_flat(tree, prefix: str, index=None):
    """(dotted name, array) leaves of a param dict; `index` picks one
    entry of stacked (scanned) leaves."""
    for key, val in tree.items():
        if isinstance(val, dict):
            yield from _lm_flat(val, f"{prefix}{key}.", index)
        else:
            yield f"{prefix}{key}", (val if index is None else val[index])


def lm_params_from_numpy(model, params: dict):
    """Load the reference's LM param pytree into a built port `Model`.

    params: `jax.tree.map(np.asarray, model.init(key))` of the reference
    `Model` of the same config.  Its `blocks` leaves carry a leading
    macro-block axis (the scanned layers) and unstack into the flat
    `model.layers`, then `tail` follows.  Every parameter of `model` must
    be given, with its shape; the reference's `x @ W` orientation is the
    port's.  Returns `model`."""
    period = len(model.cfg.layer_pattern)
    n_scan = model.cfg.num_layers // period
    flat = {k: v for k, v in params.items() if k not in ("blocks", "tail")}
    for b in range(n_scan):
        for i in range(period):
            flat.update(_lm_flat(params["blocks"][f"l{i}"], f"layers.{b * period + i}.", b))
    for j, lp in enumerate(params.get("tail", [])):
        flat.update(_lm_flat(lp, f"layers.{n_scan * period + j}."))
    state = model.state_dict()
    if set(flat) != set(state):
        raise KeyError(f"params do not match the model: missing "
                       f"{sorted(set(state) - set(flat))}, unexpected "
                       f"{sorted(set(flat) - set(state))}")
    with torch.no_grad():
        for name, a in flat.items():
            t = _lm_tensor(a)
            if tuple(t.shape) != tuple(state[name].shape):
                raise ValueError(f"{name}: shape {tuple(t.shape)}, model has "
                                 f"{tuple(state[name].shape)}")
            state[name].copy_(t)
    return model


def _lm_numpy(t: torch.Tensor) -> np.ndarray:
    """A tensor as a numpy array; bfloat16 widened to float32 (exact)."""
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def _lm_nest(tree: dict, name: str, value) -> None:
    *path, leaf = name.split(".")
    for key in path:
        tree = tree.setdefault(key, {})
    tree[leaf] = value


def lm_params_to_numpy(model, tensors: dict | None = None) -> dict:
    """The inverse of `lm_params_from_numpy`: the reference's param pytree
    layout (nested dicts, `blocks` stacked on the macro-block axis, then
    the `tail` list) of numpy arrays.

    tensors: a dict from the model's parameter names to tensors of their
    shapes (gradients, AdamW moments, ...); by default the model's own
    parameters.  bfloat16 comes back as float32, which holds it exactly."""
    cfg = model.cfg
    period = len(cfg.layer_pattern)
    n_scan = cfg.num_layers // period
    if tensors is None:
        tensors = model.state_dict()
    names = set(model.state_dict())
    if set(tensors) != names:
        raise KeyError(f"tensors do not match the model: missing "
                       f"{sorted(names - set(tensors))}, unexpected "
                       f"{sorted(set(tensors) - names)}")
    out: dict = {}
    layers: dict = {}
    for name, t in tensors.items():
        if name.startswith("layers."):
            _, i, rest = name.split(".", 2)
            layers.setdefault(int(i), {})[rest] = _lm_numpy(t)
        else:
            _lm_nest(out, name, _lm_numpy(t))
    if n_scan:
        blocks: dict = {}
        for i in range(period):
            for rest in layers[i]:
                _lm_nest(blocks, f"l{i}.{rest}",
                         np.stack([layers[b * period + i][rest] for b in range(n_scan)]))
        out["blocks"] = blocks
    tail = []
    for j in range(n_scan * period, cfg.num_layers):
        lp: dict = {}
        for rest, a in layers[j].items():
            _lm_nest(lp, rest, a)
        tail.append(lp)
    if tail:
        out["tail"] = tail
    return out
