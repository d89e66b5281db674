"""InternVL2-26B — InternViT + InternLM2 [arXiv:2404.16821].

Vision frontend (InternViT + projector) is a STUB per the assignment
carve-out: ``launch.specs.make_batch`` supplies precomputed patch
embeddings (B, 256, D).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-26b",
    family="vlm",
    source="[arXiv:2404.16821]",
    n_layers=48,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=16384,
    vocab_size=92553,
    n_patches=256,
)
