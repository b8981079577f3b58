"""The training driver's config helper: the part of `repro.launch.train`
that serving needs.  The training loop itself (`train`, with the
optimizer, data, checkpointing and gradient compression) is not ported
yet."""
from __future__ import annotations

import importlib


def reduced_config(arch: str):
    mod = importlib.import_module(
        "repro_torch.configs." + arch.replace("-", "_").replace(".", "_"))
    return mod.reduced()
