"""The MLP client model of ``repro.models.resnet`` (``init_mlp`` /
``apply_mlp``), batched over the client axis.

Parameters are a dict with the reference's keys: ``w{i}`` of shape
``(a, c)`` and ``b{i}`` of shape ``(c,)`` for one model, or ``(K, a, c)``
and ``(K, c)`` for a stack of K client models, which run together with
``torch.bmm``.  The CIFAR ResNet of the reference module is not ported
yet.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch

__all__ = ["init_mlp", "apply_mlp", "mlp_leaves", "draw_leaf"]

Params = Dict[str, torch.Tensor]


def mlp_leaves(in_dim: int, n_classes: int, hidden: int = 128,
               depth: int = 2) -> List[Tuple[str, Tuple[int, ...], Optional[float]]]:
    """``(name, shape, scale)`` of each leaf of one model, in draw order:
    ``w{i}`` He-normal (``scale = sqrt(2 / fan_in)``), ``b{i}`` zeros
    (``scale`` None)."""
    dims = [in_dim] + [hidden] * depth + [n_classes]
    leaves = []
    for i, (a, c) in enumerate(zip(dims[:-1], dims[1:])):
        leaves += [(f"w{i}", (a, c), math.sqrt(2.0 / a)), (f"b{i}", (c,), None)]
    return leaves


def draw_leaf(generator: torch.Generator, shape: Tuple[int, ...],
              scale: Optional[float], lead: Tuple[int, ...] = ()) -> torch.Tensor:
    """One leaf of :func:`mlp_leaves` for ``lead`` stacked models, drawn
    from ``generator`` on its device (zeros for ``scale`` None)."""
    if scale is None:
        return torch.zeros(lead + shape, device=generator.device)
    return torch.randn(lead + shape, generator=generator,
                       device=generator.device) * scale


def init_mlp(generator: torch.Generator, in_dim: int, n_classes: int,
             hidden: int = 128, depth: int = 2,
             stack: Optional[int] = None) -> Params:
    """He-normal weights (``normal * sqrt(2 / fan_in)``) and zero biases,
    drawn from ``generator`` on its device; ``stack=K`` draws K models at
    once with a leading client axis.  The formula is the reference's;
    the numbers differ from ``jax.random``'s."""
    lead = () if stack is None else (stack,)
    return {name: draw_leaf(generator, shape, scale, lead)
            for name, shape, scale in mlp_leaves(in_dim, n_classes, hidden, depth)}


def apply_mlp(params: Params, x: torch.Tensor) -> torch.Tensor:
    """Logits.  One model: ``x (B, d) -> (B, N)``.  A stack of K models:
    ``x (K, B, d)`` per client, or ``x (B, d)`` shared by all clients,
    ``-> (K, B, N)``."""
    n = sum(1 for k in params if k.startswith("w"))
    for i in range(n):
        w, b = params[f"w{i}"], params[f"b{i}"]
        if w.dim() == 3:
            if x.dim() == 2:
                x = x.expand(w.shape[0], -1, -1)
            x = torch.bmm(x, w) + b.unsqueeze(1)
        else:
            x = x @ w + b
        if i < n - 1:
            x = torch.relu(x)
    return x
