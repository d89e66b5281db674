"""Config registry of the port: the configurations whose model family is
ported.  The JAX package's other architectures (dense, MoE, VLM) are not
ported yet; :func:`require_ported` names the family of a configuration
that asks for one."""
from repro_torch.configs import jamba_v01_52b, mamba2_1_3b, whisper_large_v3
from repro_torch.configs.base import ModelConfig

ARCHS = {m.CONFIG.name: m.CONFIG for m in (whisper_large_v3, jamba_v01_52b, mamba2_1_3b)}

# model families with a ported forward pass (models/registry.py)
PORTED_FAMILIES = ("encdec", "hybrid", "ssm")


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
