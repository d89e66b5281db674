"""Core SCARLET library on PyTorch: aggregation sharpeners, the
synchronized soft-label cache and communication accounting."""
from repro_torch.core import cache, comm, era  # noqa: F401
