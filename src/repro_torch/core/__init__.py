"""Core SCARLET library on PyTorch: aggregation (ERA / Enhanced ERA),
the synchronized soft-label cache, the cache-hit-rate simulator,
distillation losses and communication accounting."""
from repro_torch.core import cache, cache_sim, comm, era, losses  # noqa: F401
from repro_torch.core.era import aggregate_soft_labels, enhanced_era, entropy  # noqa: F401
from repro_torch.core.losses import cross_entropy, kl_divergence, soft_cross_entropy  # noqa: F401
