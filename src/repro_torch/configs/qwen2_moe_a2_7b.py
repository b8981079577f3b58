"""qwen2-moe-a2.7b [moe] — 60 routed experts top-4 + 4 shared.

[hf:Qwen/Qwen1.5-MoE-A2.7B; hf]  24L d_model=2048 16H (GQA kv=16)
per-expert d_ff=1408, vocab=151936, head_dim=128.
Shared experts total hidden = 4 * 1408 = 5632 (matches HF config).
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="qwen2-moe-a2.7b",
    family="moe",
    num_layers=24,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    head_dim=128,
    d_ff=1408,
    vocab_size=151936,
    act="silu",
    gated_mlp=True,
    moe_num_experts=60,
    moe_top_k=4,
    moe_num_shared=4,
    moe_d_ff=1408,
    moe_dispatch="gather",   # §Perf B: scatter/gather beats (T,E,C) einsum
    moe_capacity_factor=1.0,  # §Perf B iter 3: 20% smaller expert buffers
))


def reduced() -> ArchConfig:
    return ArchConfig(
        name="qwen2-moe-a2.7b-reduced", family="moe",
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=4, head_dim=16,
        d_ff=96, vocab_size=256, act="silu", gated_mlp=True,
        moe_num_experts=8, moe_top_k=2, moe_num_shared=2, moe_d_ff=96, moe_capacity_factor=16.0,  # dropless: decode==prefill
        dtype="float32",
    )
