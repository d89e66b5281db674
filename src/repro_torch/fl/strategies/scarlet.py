"""SCARLET: Enhanced ERA power sharpening (Eq. 4) + synchronized cache."""
from __future__ import annotations

import torch

from repro_torch.core import era as era_lib
from repro_torch.fl.strategies.base import Strategy
from repro_torch.kernels import ops as kops

__all__ = ["EnhancedERAStrategy"]


class EnhancedERAStrategy(Strategy):
    """SCARLET: power sharpening (Eq. 4).

    A static ``beta`` aggregates through the fused client-mean +
    sharpening kernel (:func:`repro_torch.kernels.ops.enhanced_era_fused`).
    ``beta="adaptive"`` needs the client mean twice (entropy, then
    sharpening), so it takes the plain two-pass path, as the reference
    does:  ``beta_t = 1 + (beta_max - 1) * H_norm(z_mean)``.
    """

    name = "scarlet"
    uses_cache = True

    def _adaptive_beta(self, zbar: torch.Tensor) -> torch.Tensor:
        n = zbar.shape[-1]
        h_norm = torch.mean(era_lib.entropy(zbar)) / torch.log(
            torch.tensor(float(n), device=zbar.device))
        return 1.0 + (self.opts.get("beta_max", 2.5) - 1.0) * h_norm

    def aggregate(self, z, t):
        beta = self.opts.get("beta", 1.5)
        if beta == "adaptive":
            zbar = torch.mean(z, dim=0)
            return era_lib.enhanced_era(zbar, self._adaptive_beta(zbar)), None
        return kops.enhanced_era_fused(z, beta), None
