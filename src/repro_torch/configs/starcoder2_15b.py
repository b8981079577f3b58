"""starcoder2-15b [dense] — GQA kv=4, RoPE, non-gated GELU MLP.

[arXiv:2402.19173; hf]  40L d_model=6144 48H (GQA kv=4) d_ff=24576
vocab=49152, head_dim=128.
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="starcoder2-15b",
    family="dense",
    num_layers=40,
    d_model=6144,
    num_heads=48,
    num_kv_heads=4,
    head_dim=128,
    d_ff=24576,
    vocab_size=49152,
    act="gelu",
    gated_mlp=False,           # classic MLP (StarCoder2 uses gelu MLP)
    rope_theta=100_000.0,
))


def reduced() -> ArchConfig:
    return ArchConfig(
        name="starcoder2-15b-reduced", family="dense",
        num_layers=2, d_model=64, num_heads=8, num_kv_heads=2, head_dim=8,
        d_ff=256, vocab_size=256, act="gelu", gated_mlp=False,
        dtype="float32",
    )
