"""Aggregation sharpeners: ERA (DS-FL) and Enhanced ERA (SCARLET, Eq. 4).

Counterpart of ``repro.core.era``:

- ERA (Itahara et al., DS-FL):      ``softmax(z_mean / T)``
- Enhanced ERA (this paper, Eq. 4): ``z_mean**beta / sum_j z_mean_j**beta``

These are the plain PyTorch versions.  The fused client-mean +
Enhanced-ERA kernel is reached through
:func:`repro_torch.kernels.ops.enhanced_era_fused`.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.runtime import divide

__all__ = ["era", "enhanced_era", "entropy"]

_EPS = 1e-12


def era(z_mean: torch.Tensor, T: float, dim: int = -1) -> torch.Tensor:
    """Conventional Entropy Reduction Aggregation (DS-FL, Eq. 2): a
    temperature softmax of the already-normalized averaged labels."""
    return torch.softmax(divide(z_mean, T), dim=dim)


def enhanced_era(z_mean: torch.Tensor, beta, dim: int = -1,
                 eps: float = _EPS) -> torch.Tensor:
    """Enhanced ERA (SCARLET, Eq. 4): ``z^beta / sum z^beta``, computed
    as ``softmax(beta * log(max(z, eps)))``."""
    return torch.softmax(beta * torch.log(torch.clamp_min(z_mean, eps)), dim=dim)


def entropy(p: torch.Tensor, dim: int = -1, eps: float = _EPS) -> torch.Tensor:
    """Shannon entropy (nats) of probability vectors."""
    p = torch.clamp(p, eps, 1.0)
    return -torch.sum(p * torch.log(p), dim=dim)
