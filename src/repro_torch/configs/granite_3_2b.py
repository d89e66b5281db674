"""Granite 3.0 2B — dense GQA [hf:ibm-granite/granite-3.0-2b-base]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="granite-3-2b",
    family="dense",
    source="[hf:ibm-granite/granite-3.0-2b-base]",
    n_layers=40,
    d_model=2048,
    n_heads=32,
    n_kv_heads=8,
    head_dim=64,
    d_ff=8192,
    vocab_size=49155,
)
