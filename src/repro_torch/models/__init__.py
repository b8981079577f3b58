"""Plaintext LM model zoo (the assigned architectures) in PyTorch: the port
of `repro.models`.

`build`, `Model.init/forward/loss/init_cache/decode_step`; `sharding`
(`constrain` and `use_mesh`, the DTensor layout of model code under a
mesh) and `pipeline` (GPipe over the `pod` mesh dim).
"""
from repro_torch.models.model import Model, build  # noqa: F401
