"""Aggregation-strategy registry: one module per method (the ported
subset of ``repro.fl.strategies``)."""
from __future__ import annotations

from typing import Callable, Dict

from repro_torch.fl.strategies.base import Strategy
from repro_torch.fl.strategies.dsfl import ERAStrategy
from repro_torch.fl.strategies.scarlet import EnhancedERAStrategy

STRATEGIES: Dict[str, Callable[..., Strategy]] = {
    "dsfl": ERAStrategy,
    "scarlet": EnhancedERAStrategy,
}

__all__ = ["Strategy", "ERAStrategy", "EnhancedERAStrategy", "STRATEGIES"]
