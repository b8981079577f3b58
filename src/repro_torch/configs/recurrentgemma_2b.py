"""recurrentgemma-2b [hybrid] — RG-LRU + local attention, 1:2 pattern.

[arXiv:2402.19427; hf]  26L d_model=2560 10H (MQA kv=1) head_dim=256
d_ff=7680 vocab=256000; layer pattern (rglru, rglru, local) cycled,
local window 2048.  Sub-quadratic: runs the long_500k cell.
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    num_layers=26,
    d_model=2560,
    num_heads=10,
    num_kv_heads=1,
    head_dim=256,
    d_ff=7680,
    vocab_size=256000,
    act="gelu",
    gated_mlp=True,
    embed_scale=True,
    tie_embeddings=True,
    layer_pattern=("rglru", "rglru", "local"),
    local_window=2048,
    rglru_width=2560,
))


def reduced() -> ArchConfig:
    return ArchConfig(
        name="recurrentgemma-2b-reduced", family="hybrid",
        num_layers=5, d_model=64, num_heads=2, num_kv_heads=1, head_dim=32,
        d_ff=128, vocab_size=256, act="gelu", gated_mlp=True,
        embed_scale=True, tie_embeddings=True,
        layer_pattern=("rglru", "rglru", "local"), local_window=16,
        rglru_width=64, dtype="float32",
    )
