"""Aggregation-strategy registry: one module per method (counterpart of
``repro.fl.strategies``)."""
from __future__ import annotations

from typing import Callable, Dict

from repro_torch.fl.strategies.base import Strategy
from repro_torch.fl.strategies.cfd import CFDStrategy
from repro_torch.fl.strategies.comet import COMETStrategy
from repro_torch.fl.strategies.dsfl import ERAStrategy
from repro_torch.fl.strategies.mean import MeanStrategy
from repro_torch.fl.strategies.scarlet import EnhancedERAStrategy
from repro_torch.fl.strategies.selective_fd import SelectiveFDStrategy

STRATEGIES: Dict[str, Callable[..., Strategy]] = {
    "mean": MeanStrategy,
    "dsfl": ERAStrategy,
    "scarlet": EnhancedERAStrategy,
    "cfd": CFDStrategy,
    "comet": COMETStrategy,
    "selective_fd": SelectiveFDStrategy,
}

__all__ = ["Strategy", "MeanStrategy", "ERAStrategy", "EnhancedERAStrategy",
           "CFDStrategy", "COMETStrategy", "SelectiveFDStrategy", "STRATEGIES"]
