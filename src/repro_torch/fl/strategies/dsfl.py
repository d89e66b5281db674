"""DS-FL (Itahara et al. 2020): ERA temperature-softmax sharpening."""
from __future__ import annotations

import torch

from repro_torch.core import era as era_lib
from repro_torch.fl.strategies.base import Strategy

__all__ = ["ERAStrategy"]


class ERAStrategy(Strategy):
    """DS-FL: temperature-softmax sharpening of the average (no cache,
    no kernel)."""

    name = "dsfl"
    scan_safe = True
    analysis_variants = ({}, {"T": 0.5})

    def aggregate(self, z, um, t):
        return era_lib.era(torch.mean(z, dim=0), self.opts.get("T", 0.1)), None

    # two-phase contract: the linear phase is inherited (weighted sum);
    # the temperature softmax runs once on the reduced mean
    def finalize_aggregate(self, partials, t):
        zbar = super().finalize_aggregate(partials, t)
        return era_lib.era(zbar, self.opts.get("T", 0.1))
