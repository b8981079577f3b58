"""pixtral-12b [vlm] — Pixtral ViT frontend (stub) + Mistral-NeMo backbone.

[hf:mistralai/Pixtral-12B-2409; unverified]
40L d_model=5120 32H (GQA kv=8) head_dim=128 d_ff=14336 vocab=131072.
The vision frontend is a STUB per the assignment: `input_specs()` feeds
precomputed patch embeddings (dim 1024) for the image prefix.
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="pixtral-12b",
    family="vlm",
    num_layers=40,
    d_model=5120,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=131072,
    act="silu",
    gated_mlp=True,
    rope_theta=1_000_000_000.0,
    frontend="patch",
    frontend_dim=1024,
    frontend_len=256,          # 256 patch tokens prefix
))


def reduced() -> ArchConfig:
    return ArchConfig(
        name="pixtral-12b-reduced", family="vlm",
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
        d_ff=128, vocab_size=256, act="silu", gated_mlp=True,
        frontend="patch", frontend_dim=32, frontend_len=8,
        dtype="float32",
    )
