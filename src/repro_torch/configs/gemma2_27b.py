"""Gemma 2 27B — local+global alternating attention, logit softcap [arXiv:2408.00118]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-27b",
    family="dense",
    source="[arXiv:2408.00118]",
    n_layers=46,
    d_model=4608,
    n_heads=32,
    n_kv_heads=16,
    head_dim=128,
    d_ff=36864,
    vocab_size=256000,
    attn_softcap=50.0,
    final_softcap=30.0,
    sliding_window=4096,
    local_global_alternating=True,
)
