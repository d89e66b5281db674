"""Selective-FD: confidence-gated uploads."""
from __future__ import annotations

import math

import torch

from repro_torch.core import era as era_lib
from repro_torch.fl.strategies.base import Strategy
from repro_torch.kernels.runtime import divide

__all__ = ["SelectiveFDStrategy"]


class SelectiveFDStrategy(Strategy):
    """Selective-FD: clients upload only confident (low-entropy)
    soft-labels; the server averages over the uploaders of each sample."""

    name = "selective_fd"
    scan_safe = True
    analysis_variants = ({}, {"tau_client": 0.25})

    def __init__(self, tau_client: float = 0.0625, **kw):
        super().__init__(**kw)
        self.tau = tau_client

    def upload_mask(self, z):
        # normalized entropy in [0, 1]; upload when confident.  log(N) is a
        # Python float, as a float32 divisor equal to the reference's
        # jnp.log(N); ``divide`` keeps it a true division on the card.
        h = divide(era_lib.entropy(z), math.log(z.shape[-1]))
        return h <= (1.0 - self.tau)

    def aggregate(self, z, um, t):
        w = um.to(z.dtype)[..., None]
        num = torch.sum(z * w, dim=0)
        den = torch.clamp_min(torch.sum(w, dim=0), 1e-9)
        teacher = num / den
        # samples nobody uploaded: fall back to the plain mean
        empty = (torch.sum(um, dim=0) == 0)[:, None]
        return torch.where(empty, torch.mean(z, dim=0), teacher), None

    # Two-phase contract: the linear phase carries the upload-weighted
    # sums beside the inherited participant sums (for the fallback); the
    # ratio and the empty-sample fallback run on the reduced moments.
    def partial_aggregate(self, z, part, um, t):
        p = super().partial_aggregate(z, part, None, t)
        w = (um.to(z.dtype) * part[:, None])[..., None]   # (K, m, 1)
        p["up_num"] = torch.sum(z * w, dim=0)
        p["up_den"] = torch.sum(w, dim=0)
        return p

    def finalize_aggregate(self, partials, t):
        den = partials["up_den"]
        teacher = partials["up_num"] / torch.clamp_min(den, 1e-9)
        # samples no participant uploaded: the participant-mean fallback
        fallback = super().finalize_aggregate(partials, t)
        return torch.where(den < 0.5, fallback, teacher)
