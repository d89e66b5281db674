"""Aggregation sharpeners: ERA (DS-FL) and Enhanced ERA (SCARLET, Eq. 4).

Counterpart of ``repro.core.era``:

- ERA (Itahara et al., DS-FL):      ``softmax(z_mean / T)``
- Enhanced ERA (this paper, Eq. 4): ``z_mean**beta / sum_j z_mean_j**beta``

``enhanced_era`` (and ``aggregate_soft_labels`` through it) takes
``impl="torch"``, the plain differentiable PyTorch path (the reference's
``"jnp"``), or ``impl="kernel"``, the per-row Enhanced-ERA kernel behind
:func:`repro_torch.kernels.ops.enhanced_era` (the reference's
``"pallas"``), which is forward only.  The fused client-mean +
Enhanced-ERA kernel is reached through
:func:`repro_torch.kernels.ops.enhanced_era_fused`.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import ops as kops
from repro_torch.kernels.runtime import divide

__all__ = ["softmax_with_temperature", "era", "enhanced_era", "aggregate_soft_labels",
           "entropy", "log_prob_ratio", "IMPLS"]

_EPS = 1e-12
IMPLS = ("torch", "kernel")


def _check_impl(impl: str) -> None:
    if impl not in IMPLS:
        raise ValueError(f"unknown impl {impl!r}; expected one of {IMPLS}")


def softmax_with_temperature(logits: torch.Tensor, T: float, dim: int = -1) -> torch.Tensor:
    """Temperature softmax; ``T -> 0`` approaches one-hot argmax."""
    return torch.softmax(divide(logits, T), dim=dim)


def era(z_mean: torch.Tensor, T: float, dim: int = -1) -> torch.Tensor:
    """Conventional Entropy Reduction Aggregation (DS-FL, Eq. 2): a
    temperature softmax of the already-normalized averaged labels."""
    return softmax_with_temperature(z_mean, T, dim=dim)


def enhanced_era(z_mean: torch.Tensor, beta, dim: int = -1,
                 eps: float = _EPS, impl: str = "torch") -> torch.Tensor:
    """Enhanced ERA (SCARLET, Eq. 4): ``z^beta / sum z^beta``, computed
    as ``softmax(beta * log(max(z, eps)))``.  ``impl="kernel"`` needs the
    classes on the last dim and uses the kernel's fixed eps of 1e-12."""
    _check_impl(impl)
    if impl == "kernel":
        if dim not in (-1, z_mean.dim() - 1):
            raise ValueError("impl='kernel' requires the classes on the last dim")
        return kops.enhanced_era(z_mean, beta)
    return torch.softmax(beta * torch.log(torch.clamp_min(z_mean, eps)), dim=dim)


def aggregate_soft_labels(z_clients: torch.Tensor, method: str = "enhanced_era", *,
                          beta=1.0, T: float = 0.1,
                          weights: Optional[torch.Tensor] = None,
                          impl: str = "torch") -> torch.Tensor:
    """Aggregate per-client soft-labels ``(K, ..., N) -> (..., N)``: the
    mean over clients, or the ``weights``-weighted sum with the weights
    normalized by their sum; then ``method`` ``"mean"`` (no sharpening),
    ``"era"`` or ``"enhanced_era"``."""
    _check_impl(impl)
    if z_clients.dim() < 2:
        raise ValueError("expected (K, ..., N)")
    if weights is None:
        z_mean = torch.mean(z_clients, dim=0)
    else:
        z_mean = torch.tensordot(weights / torch.sum(weights), z_clients, dims=([0], [0]))
    if method == "mean":
        return z_mean
    if method == "era":
        return era(z_mean, T)
    if method == "enhanced_era":
        return enhanced_era(z_mean, beta, impl=impl)
    raise ValueError(f"unknown aggregation method: {method}")


def entropy(p: torch.Tensor, dim: int = -1, eps: float = _EPS) -> torch.Tensor:
    """Shannon entropy (nats) of probability vectors."""
    p = torch.clamp(p, eps, 1.0)
    return -torch.sum(p * torch.log(p), dim=dim)


def log_prob_ratio(p: torch.Tensor, i: int, j: int, dim: int = -1) -> torch.Tensor:
    """``ln(p_i / p_j)``, the Appendix-C stability diagnostic."""
    pi, pj = p.select(dim, i), p.select(dim, j)
    return torch.log(torch.clamp_min(pi, _EPS)) - torch.log(torch.clamp_min(pj, _EPS))
