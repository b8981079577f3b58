"""moonshot-v1-16b-a3b [moe] — kimi/moonlight family, 64 routed top-6.

[hf:moonshotai/Moonlight-16B-A3B; hf]  48L d_model=2048 16H (GQA kv=16)
per-expert d_ff=1408, vocab=163840, head_dim=128, 2 shared experts.
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="moonshot-v1-16b-a3b",
    family="moe",
    num_layers=48,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    head_dim=128,
    d_ff=1408,
    vocab_size=163840,
    act="silu",
    gated_mlp=True,
    moe_num_experts=64,
    moe_top_k=6,
    moe_num_shared=2,
    moe_d_ff=1408,
    moe_dispatch="gather",   # §Perf B: scatter/gather beats (T,E,C) einsum
    moe_capacity_factor=1.0,  # §Perf B iter 3: 20% smaller expert buffers
))


def reduced() -> ArchConfig:
    return ArchConfig(
        name="moonshot-v1-16b-a3b-reduced", family="moe",
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=4, head_dim=16,
        d_ff=96, vocab_size=256, act="silu", gated_mlp=True,
        moe_num_experts=8, moe_top_k=3, moe_num_shared=1, moe_d_ff=96, moe_capacity_factor=16.0,  # dropless: decode==prefill
        dtype="float32",
    )
