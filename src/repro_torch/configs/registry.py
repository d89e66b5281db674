"""Config registry of the port: --arch <id> -> ModelConfig, for every
architecture of the JAX package whose model family is ported (all but
the ResNet-20 CNN, ``resnet20-cifar``, whose family is not);
:func:`require_ported` names the family of a configuration that asks for
an unported one."""
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
    whisper_large_v3,
)
from repro_torch.configs.base import ModelConfig

# the reference's order (repro.configs.registry.ARCHS)
ARCHS = {
    m.CONFIG.name: m.CONFIG
    for m in (
        kimi_k2_1t_a32b, internvl2_26b, jamba_v01_52b, grok_1_314b,
        gemma2_27b, granite_3_2b, phi4_mini_3_8b, granite_3_8b,
        whisper_large_v3, mamba2_1_3b,
    )
}

# the reference's ASSIGNED: every architecture but resnet20-cifar
ASSIGNED = list(ARCHS)

# model families with a ported forward pass (models/registry.py)
PORTED_FAMILIES = ("dense", "moe", "vlm", "encdec", "hybrid", "ssm")


def require_ported(cfg: ModelConfig) -> ModelConfig:
    """``cfg`` itself if its family is ported; else NotImplementedError
    naming the family."""
    if cfg.family not in PORTED_FAMILIES:
        raise NotImplementedError(
            f"model family {cfg.family!r} ({cfg.name}) is not ported to "
            f"repro_torch; ported: {', '.join(PORTED_FAMILIES)}")
    return cfg


def get(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown or unported arch {name!r}; available: {sorted(ARCHS)}")
    return ARCHS[name]
