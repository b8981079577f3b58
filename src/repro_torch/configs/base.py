"""Architecture configs for the assigned 10-arch pool + shape specs.

The port's own copy of `repro.configs.base`, field for field.  Every
field is explicit (no HF dependency); values follow the assignment table
and the cited sources.  `repro_torch.models.build(cfg, device)` turns a
config into a `Model` module.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

REGISTRY: dict = {}


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                 # dense | moe | ssm | hybrid | audio | vlm
    num_layers: int
    d_model: int
    num_heads: int              # query heads (0 => attention-free)
    num_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int

    act: str = "silu"           # silu | gelu
    gated_mlp: bool = True      # SwiGLU/GeGLU vs plain MLP
    qk_norm: bool = False
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-6
    embed_scale: bool = False   # gemma-style sqrt(d_model) embedding scale
    tie_embeddings: bool = False

    # MoE
    moe_num_experts: int = 0    # routed experts
    moe_top_k: int = 0
    moe_num_shared: int = 0
    moe_d_ff: int = 0           # per-expert hidden
    moe_capacity_factor: float = 1.25  # large => dropless (exact routing)
    moe_dispatch: str = "einsum"       # einsum | gather  (§Perf B)

    # SSM (mamba2 / SSD)
    ssm_state_dim: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 256

    # layer pattern, cycled over depth: entries in
    # {"attn", "local", "rglru", "ssd"}; MLP follows every entry.
    layer_pattern: Tuple[str, ...] = ("attn",)
    local_window: int = 2048
    rglru_width: int = 0        # 0 => d_model

    # modality frontend stub (assignment: precomputed embeddings)
    frontend: str = "none"      # none | patch | frame
    frontend_dim: int = 0
    frontend_len: int = 0       # number of prefix positions fed by frontend

    # numeric
    dtype: str = "bfloat16"

    @property
    def attn_free(self) -> bool:
        return all(p == "ssd" for p in self.layer_pattern)

    @property
    def sub_quadratic(self) -> bool:
        """True if long-context decode is feasible (no full-attn KV cache)."""
        return all(p in ("ssd", "rglru", "local") for p in self.layer_pattern)

    @property
    def is_moe(self) -> bool:
        return self.moe_num_experts > 0

    def pattern_at(self, layer: int) -> str:
        return self.layer_pattern[layer % len(self.layer_pattern)]

    def param_count(self) -> int:
        """Approximate parameter count (embeddings included)."""
        d, L = self.d_model, self.num_layers
        emb = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        per_layer = 0
        n_attn = sum(1 for i in range(L) if self.pattern_at(i) in ("attn", "local"))
        n_rglru = sum(1 for i in range(L) if self.pattern_at(i) == "rglru")
        n_ssd = sum(1 for i in range(L) if self.pattern_at(i) == "ssd")
        qkv = d * self.head_dim * (self.num_heads + 2 * self.num_kv_heads) \
            + self.num_heads * self.head_dim * d
        per_layer += n_attn * qkv / max(L, 1)
        if n_rglru:
            di = d  # rg-lru width ~ d_model
            per_layer += n_rglru * (3 * d * di + 4 * di) / L
        if n_ssd:
            di = self.ssm_expand * d
            nh = di // self.ssm_head_dim
            per_layer += n_ssd * (d * (2 * di + 2 * self.ssm_state_dim + nh) + di * d) / L
        if self.is_moe:
            ff = (2 if self.gated_mlp else 1) * self.moe_d_ff + self.moe_d_ff
            per_expert = d * ff
            per_layer += (self.moe_num_experts + self.moe_num_shared) * per_expert \
                + d * self.moe_num_experts
        else:
            per_layer += d * self.d_ff * (3 if self.gated_mlp else 2)
        return int(emb + L * per_layer)

    def active_param_count(self) -> int:
        """Per-token active params (MoE: only routed top-k + shared)."""
        if not self.is_moe:
            return self.param_count()
        d, L = self.d_model, self.num_layers
        emb = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        qkv = d * self.head_dim * (self.num_heads + 2 * self.num_kv_heads) \
            + self.num_heads * self.head_dim * d
        ff = (2 if self.gated_mlp else 1) * self.moe_d_ff + self.moe_d_ff
        active = (self.moe_top_k + self.moe_num_shared) * d * ff + d * self.moe_num_experts
        return int(emb + L * (qkv + active))


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str          # train | prefill | decode


SHAPES = {
    "train_4k":    ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k":  ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k":   ShapeSpec("long_500k", 524_288, 1, "decode"),
}


def register(cfg: ArchConfig) -> ArchConfig:
    REGISTRY[cfg.name] = cfg
    return cfg


def get(name: str) -> ArchConfig:
    if name not in REGISTRY:
        import repro_torch.configs  # noqa: F401  (triggers registration)
    return REGISTRY[name]


def applicable_shapes(cfg: ArchConfig) -> list:
    """Shape cells for this arch per the assignment contract."""
    out = ["train_4k", "prefill_32k", "decode_32k"]
    if cfg.sub_quadratic:
        out.append("long_500k")  # skip for pure full-attention archs
    return out
