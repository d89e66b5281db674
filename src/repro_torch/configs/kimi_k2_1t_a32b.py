"""Kimi K2 — trillion-param MoE (paper-table) [arXiv:2501.kimi2]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b",
    family="moe",
    source="[arXiv:2501.kimi2]",
    n_layers=61,
    d_model=7168,
    n_heads=64,
    n_kv_heads=8,
    d_ff=2048,
    moe_d_ff=2048,
    vocab_size=163840,
    n_experts=384,
    top_k=8,
    n_shared_experts=1,
)
