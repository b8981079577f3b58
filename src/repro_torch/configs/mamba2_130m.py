"""mamba2-130m [ssm] — SSD (state-space duality), attention-free.

[arXiv:2405.21060; unverified]  24L d_model=768, ssm_state=128,
expand=2 (inner 1536), head_dim=64 (24 SSD heads), vocab=50280.
Attention-free => runs the long_500k cell.
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="mamba2-130m",
    family="ssm",
    num_layers=24,
    d_model=768,
    num_heads=0,               # attention-free
    num_kv_heads=0,
    head_dim=0,
    d_ff=0,                    # no separate MLP: SSD mixer only
    vocab_size=50280,
    tie_embeddings=True,
    layer_pattern=("ssd",),
    ssm_state_dim=128,
    ssm_head_dim=64,
    ssm_expand=2,
    ssm_chunk=256,
))


def reduced() -> ArchConfig:
    return ArchConfig(
        name="mamba2-130m-reduced", family="ssm",
        num_layers=2, d_model=64, num_heads=0, num_kv_heads=0, head_dim=0,
        d_ff=0, vocab_size=256, tie_embeddings=True, layer_pattern=("ssd",),
        ssm_state_dim=16, ssm_head_dim=16, ssm_expand=2, ssm_chunk=32,
        dtype="float32",
    )
