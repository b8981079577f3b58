"""deepseek-coder-33b [dense] — llama-arch SwiGLU, GQA kv=8.

[arXiv:2401.14196; hf]  62L d_model=7168 56H (GQA kv=8) d_ff=19200
vocab=32256, head_dim=128.
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="deepseek-coder-33b",
    family="dense",
    num_layers=62,
    d_model=7168,
    num_heads=56,
    num_kv_heads=8,
    head_dim=128,
    d_ff=19200,
    vocab_size=32256,
    act="silu",
    gated_mlp=True,
    rope_theta=100_000.0,
))


def reduced() -> ArchConfig:
    return ArchConfig(
        name="deepseek-coder-33b-reduced", family="dense",
        num_layers=3, d_model=64, num_heads=8, num_kv_heads=2, head_dim=8,
        d_ff=192, vocab_size=256, act="silu", gated_mlp=True,
        dtype="float32",
    )
