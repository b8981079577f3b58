"""Assigned architecture registry — importing this package registers all 10.

Each `<arch>.py` holds the exact published config plus `reduced()` — the
same family at smoke-test scale (small layers/width/experts/vocab).
"""
from repro_torch.configs.base import ArchConfig, ShapeSpec, SHAPES, REGISTRY, get, applicable_shapes  # noqa: F401

from repro_torch.configs import (  # noqa: F401  (registration side effects)
    pixtral_12b,
    gemma_7b,
    starcoder2_15b,
    deepseek_coder_33b,
    qwen3_0_6b,
    recurrentgemma_2b,
    qwen2_moe_a2_7b,
    moonshot_v1_16b_a3b,
    mamba2_130m,
    musicgen_large,
)

ARCH_IDS = [
    "pixtral-12b", "gemma-7b", "starcoder2-15b", "deepseek-coder-33b",
    "qwen3-0.6b", "recurrentgemma-2b", "qwen2-moe-a2.7b",
    "moonshot-v1-16b-a3b", "mamba2-130m", "musicgen-large",
]
