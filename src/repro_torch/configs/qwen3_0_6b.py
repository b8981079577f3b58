"""qwen3-0.6b [dense] — qk_norm, GQA kv=8, tied embeddings.

[hf:Qwen/Qwen3-8B (family); hf]  28L d_model=1024 16H (GQA kv=8)
d_ff=3072 vocab=151936, head_dim=128 (projected: 16*128 = 2048 != d_model).
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="qwen3-0.6b",
    family="dense",
    num_layers=28,
    d_model=1024,
    num_heads=16,
    num_kv_heads=8,
    head_dim=128,
    d_ff=3072,
    vocab_size=151936,
    act="silu",
    gated_mlp=True,
    qk_norm=True,
    rope_theta=1_000_000.0,
    tie_embeddings=True,
))


def reduced() -> ArchConfig:
    return ArchConfig(
        name="qwen3-0.6b-reduced", family="dense",
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, head_dim=32,
        d_ff=128, vocab_size=256, act="silu", gated_mlp=True, qk_norm=True,
        tie_embeddings=True, dtype="float32",
    )
