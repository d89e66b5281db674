"""Config registry of the port: --arch <id> -> ModelConfig, for every
architecture of the JAX package (``repro.configs.registry``), in its
order."""
from repro_torch.configs import (
    gemma2_27b,
    granite_3_2b,
    granite_3_8b,
    grok_1_314b,
    internvl2_26b,
    jamba_v01_52b,
    kimi_k2_1t_a32b,
    mamba2_1_3b,
    phi4_mini_3_8b,
    resnet20_cifar,
    whisper_large_v3,
)
from repro_torch.configs.base import ModelConfig

ARCHS = {
    m.CONFIG.name: m.CONFIG
    for m in (
        kimi_k2_1t_a32b, internvl2_26b, jamba_v01_52b, grok_1_314b,
        gemma2_27b, granite_3_2b, phi4_mini_3_8b, granite_3_8b,
        whisper_large_v3, mamba2_1_3b, resnet20_cifar,
    )
}

ASSIGNED = [n for n in ARCHS if n != "resnet20-cifar"]


def get(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; available: {sorted(ARCHS)}")
    return ARCHS[name]
