"""Optimizer substrate (no optax in the reference, no `torch.optim` here):
AdamW + cosine schedule + global clip."""
from repro_torch.optim.adamw import AdamW, adamw_init, adamw_update, global_norm  # noqa: F401
from repro_torch.optim.schedule import cosine_schedule  # noqa: F401
