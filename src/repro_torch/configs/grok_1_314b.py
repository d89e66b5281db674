"""Grok-1 314B — MoE 8 experts top-2 [hf:xai-org/grok-1]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="grok-1-314b",
    family="moe",
    source="[hf:xai-org/grok-1]",
    n_layers=64,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=32768,
    moe_d_ff=32768,
    vocab_size=131072,
    n_experts=8,
    top_k=2,
)
