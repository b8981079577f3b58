"""gemma-7b [dense] — GeGLU, head_dim=256, tied embeddings, 256k vocab.

[arXiv:2403.08295; hf]  28L d_model=3072 16H (GQA kv=16) d_ff=24576.
Gemma conventions: sqrt(d_model) embedding scale, (1 + w) RMSNorm weights.
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="gemma-7b",
    family="dense",
    num_layers=28,
    d_model=3072,
    num_heads=16,
    num_kv_heads=16,
    head_dim=256,
    d_ff=24576,
    vocab_size=256000,
    act="gelu",
    gated_mlp=True,            # GeGLU
    embed_scale=True,
    tie_embeddings=True,
))


def reduced() -> ArchConfig:
    return ArchConfig(
        name="gemma-7b-reduced", family="dense",
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=4, head_dim=32,
        d_ff=256, vocab_size=256, act="gelu", gated_mlp=True,
        embed_scale=True, tie_embeddings=True, dtype="float32",
    )
