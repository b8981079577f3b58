"""Carry key material and ciphertexts across from numpy.

The reference keeps torus values as uint64; the port carries the same
bits as int64 (`ndarray.view(np.int64)`).  These helpers import no JAX:
a caller hands over `np.asarray(...)` of the reference's arrays.
"""
from __future__ import annotations

import numpy as np
import torch

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
