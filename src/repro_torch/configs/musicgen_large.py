"""musicgen-large [audio] — decoder-only transformer over EnCodec tokens.

[arXiv:2306.05284; hf]  48L d_model=2048 32H (kv=32, full MHA) d_ff=8192
vocab=2048 (EnCodec codebook), head_dim=64.  The EnCodec frontend is a
STUB per the assignment: `input_specs()` feeds precomputed conditioning
frame embeddings (dim 768, e.g. T5 text conditioning) as a prefix.
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="musicgen-large",
    family="audio",
    num_layers=48,
    d_model=2048,
    num_heads=32,
    num_kv_heads=32,
    head_dim=64,
    d_ff=8192,
    vocab_size=2048,
    act="gelu",
    gated_mlp=False,
    frontend="frame",
    frontend_dim=768,
    frontend_len=64,
))


def reduced() -> ArchConfig:
    return ArchConfig(
        name="musicgen-large-reduced", family="audio",
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=4, head_dim=16,
        d_ff=128, vocab_size=128, act="gelu", gated_mlp=False,
        frontend="frame", frontend_dim=32, frontend_len=8,
        dtype="float32",
    )
