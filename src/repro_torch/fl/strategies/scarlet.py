"""SCARLET: Enhanced ERA power sharpening (Eq. 4) + synchronized cache."""
from __future__ import annotations

import math

import torch

from repro_torch.core import era as era_lib
from repro_torch.fl.strategies.base import Strategy
from repro_torch.kernels import ops as kops
from repro_torch.kernels.runtime import divide

__all__ = ["EnhancedERAStrategy"]


def _participant_weights(part: torch.Tensor) -> torch.Tensor:
    """``part * (K / max(sum(part), 1))``: the weights under which a
    kernel's ``sum / K`` over the full stack is the participant mean.
    ``K / n`` is a true float32 division, as in the reference (PyTorch's
    ``scalar / tensor`` would multiply by a reciprocal)."""
    n_part = torch.clamp_min(part.sum(), 1.0)
    return part * (torch.full_like(n_part, float(part.shape[0])) / n_part)


def _outage_guard(part: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    """On a total outage the kernels' zero-input teacher differs from the
    two-phase path's uniform one; engines gate such rounds out, but the
    contract is total, so align."""
    return torch.where(part.sum() > 0, out,
                       torch.full_like(out, 1.0 / out.shape[-1]))


class EnhancedERAStrategy(Strategy):
    """SCARLET: power sharpening (Eq. 4).

    A static ``beta`` aggregates through the fused client-mean +
    sharpening kernel (:func:`repro_torch.kernels.ops.enhanced_era_fused`),
    or, on the device engine's fused path, through the fused round kernel
    (:func:`repro_torch.kernels.ops.fused_round`).  ``beta="adaptive"``
    needs the client mean twice (entropy, then sharpening), so it takes
    the plain two-pass path, as the reference does:
    ``beta_t = 1 + (beta_max - 1) * H_norm(z_mean)``.
    """

    name = "scarlet"
    uses_cache = True
    scan_safe = True
    analysis_variants = ({}, {"beta": "adaptive"})

    def _adaptive_beta(self, zbar: torch.Tensor) -> torch.Tensor:
        # math.log(n) is a Python float, so no host-to-device copy; as a
        # float32 divisor it equals the reference's jnp.log(n)
        n = zbar.shape[-1]
        h_norm = divide(torch.mean(era_lib.entropy(zbar)), math.log(n))
        return 1.0 + (self.opts.get("beta_max", 2.5) - 1.0) * h_norm

    def sharpen_gauge(self, zbar, t):
        beta = self.opts.get("beta", 1.5)
        if beta == "adaptive":
            return self._adaptive_beta(zbar).to(torch.float32)
        return torch.full((), beta, dtype=torch.float32, device=zbar.device)

    def aggregate(self, z, um, t):
        beta = self.opts.get("beta", 1.5)
        if beta == "adaptive":
            zbar = torch.mean(z, dim=0)
            return era_lib.enhanced_era(zbar, self._adaptive_beta(zbar)), None
        return kops.enhanced_era_fused(z, beta), None

    # two-phase contract: the linear phase is the inherited weighted sum;
    # the sharpening runs once on the reduced mean
    def finalize_aggregate(self, partials, t):
        zbar = super().finalize_aggregate(partials, t)
        beta = self.opts.get("beta", 1.5)
        if beta == "adaptive":
            beta = self._adaptive_beta(zbar)
        return era_lib.enhanced_era(zbar, beta)

    def aggregate_masked(self, z, part, um, t):
        beta = self.opts.get("beta", 1.5)
        if beta == "adaptive":  # needs zbar twice -> two-phase path
            return super().aggregate_masked(z, part, um, t)
        # the ERA kernel's sum / K over the weighted full stack is the
        # participant mean
        zw = z * _participant_weights(part)[:, None, None]
        return _outage_guard(part, kops.enhanced_era_fused(zw, beta))

    # ------------------------------------------------------------------
    # Fused round path: codec round trip + masked aggregation +
    # sharpening in one fused_round kernel.  Static beta only: adaptive
    # beta needs the client mean before sharpening, which the kernel
    # never materializes.

    @property
    def supports_fused_round(self):
        return self.opts.get("beta", 1.5) != "adaptive"

    def aggregate_masked_fused(self, z, part, codec_spec, base, t):
        out = kops.fused_round(z, _participant_weights(part),
                               self.opts.get("beta", 1.5), base,
                               mode=codec_spec["mode"],
                               bits=codec_spec["bits"], sharpen=True)
        return _outage_guard(part, out)

    def partial_aggregate_fused(self, z, part, codec_spec, base, t):
        # linear phase only; finalize_aggregate sharpens once after the
        # cross-shard sum, as on the per-op path
        zsum = kops.fused_round(z, part, None, base, mode=codec_spec["mode"],
                                bits=codec_spec["bits"], sharpen=False)
        return {"zsum": zsum, "wsum": part.sum()}
