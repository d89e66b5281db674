"""Config registry of the port: the configurations whose model family is
ported.  The JAX package's other architectures (dense, MoE, SSM, hybrid,
VLM) are not ported yet; :func:`require_ported` names the family of a
configuration that asks for one."""
from repro_torch.configs import whisper_large_v3
from repro_torch.configs.base import ModelConfig

ARCHS = {m.CONFIG.name: m.CONFIG for m in (whisper_large_v3,)}

# model families with a ported forward pass (models/registry.py)
PORTED_FAMILIES = ("encdec",)


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
