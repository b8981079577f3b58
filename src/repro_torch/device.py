"""Device selection for the port's entry points.

Every entry point (context keygen, engine, interop) runs on the card
unless the caller names another device.  A call that names no device on
a machine without CUDA raises instead of quietly running on the CPU.
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """`None` -> the current CUDA device (raises without one); anything
    else -> `torch.device(device)`."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on a CUDA device by default and none is "
                "available; pass device='cpu' to run the plain PyTorch path")
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(device)
