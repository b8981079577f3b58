"""Plaintext LM model zoo (the assigned architectures) in PyTorch: the port
of `repro.models`.

Serving path only: `build`, `Model.init/forward/init_cache/decode_step`.
The training loss, pipeline parallelism and mesh sharding rules are not
ported (one card has no mesh).
"""
from repro_torch.models.model import Model, build  # noqa: F401
