"""Plain soft-label averaging (no sharpening): the FD baseline."""
from __future__ import annotations

import torch

from repro_torch.fl.strategies.base import Strategy

__all__ = ["MeanStrategy"]


class MeanStrategy(Strategy):
    """Inherits the base two-phase masked aggregation unchanged: the
    participation-weighted mean is the whole method."""

    name = "mean"
    scan_safe = True

    def aggregate(self, z, um, t):
        return torch.mean(z, dim=0), None
