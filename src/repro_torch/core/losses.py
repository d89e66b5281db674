"""Losses: hard-label CE and soft-target distillation (KL / soft CE).

Counterpart of ``repro.core.losses``.  ``soft_cross_entropy`` takes
``impl="torch"``, the plain differentiable PyTorch path (the reference's
``"jnp"``), or ``impl="kernel"``, the one-pass distillation loss kernel
behind :func:`repro_torch.kernels.ops.distill_loss` for large class
counts (LM vocabularies; the reference's ``"pallas"``), which computes
in float32 and is forward only.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ops as kops

__all__ = ["cross_entropy", "soft_cross_entropy", "kl_divergence", "IMPLS"]

_EPS = 1e-12
IMPLS = ("torch", "kernel")


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Mean CE over integer labels; ignores entries where label < 0."""
    logp = torch.log_softmax(logits, dim=dim)
    mask = labels >= 0
    safe = torch.where(mask, labels, 0).long()
    nll = -torch.gather(logp, dim, safe.unsqueeze(-1)).squeeze(-1)
    nll = torch.where(mask, nll, 0.0)
    return torch.sum(nll) / torch.clamp_min(torch.sum(mask), 1)


def soft_cross_entropy(logits: torch.Tensor, teacher: torch.Tensor,
                       impl: str = "torch") -> torch.Tensor:
    """Mean ``-sum_j teacher_j * log_softmax(logits)_j`` (soft-target CE).

    Equal to ``KL(teacher || student) + H(teacher)``: the same gradients as
    the KL distillation loss used in the paper (phi_dist)."""
    if impl not in IMPLS:
        raise ValueError(f"unknown impl {impl!r}; expected one of {IMPLS}")
    if impl == "kernel":
        return kops.distill_loss(logits, teacher)
    logp = torch.log_softmax(logits, dim=-1)
    return -torch.mean(torch.sum(teacher * logp, dim=-1))


def kl_divergence(teacher: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """Mean ``KL(teacher || softmax(logits))`` (the paper's phi_dist)."""
    logp = torch.log_softmax(logits, dim=-1)
    t = torch.clamp(teacher, _EPS, 1.0)
    return torch.mean(torch.sum(t * (torch.log(t) - logp), dim=-1))
