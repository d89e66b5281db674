"""Jamba v0.1 52B — Mamba+attention 1:7 interleave, MoE 16e top-2 [arXiv:2403.19887]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="jamba-v0.1-52b",
    family="hybrid",
    source="[arXiv:2403.19887]",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    moe_d_ff=14336,
    vocab_size=65536,
    n_experts=16,
    top_k=2,
    moe_every=2,
    attn_layer_period=8,
    ssm_state=16,
    ssm_head_dim=64,
    ssm_expand=2,
)
