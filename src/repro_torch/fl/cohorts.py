"""Client-model cohorts: heterogeneous MLP architectures across the client
axis (counterpart of ``repro.fl.cohorts``).

A cohort is a contiguous block of clients that run the same model, so
their parameters stack into one ``(n, a, c)`` dict; ``client_params`` is
a list with one such dict per cohort.  Everything downstream of the soft
predictions (strategies, codecs, cache, ledger) sees one ``(K, m, N)``
stack in global client order.  For a single cohort ``split`` and
``concat`` are the identity on the same tensor.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence, Tuple

import numpy as np
import torch

from repro_torch.models.resnet import Params, init_mlp

__all__ = ["CohortSpec", "ClientModels", "resolve_cohorts"]

_FAMILIES = ("mlp",)


@dataclass(frozen=True)
class CohortSpec:
    """One cohort: ``n_clients`` clients all running the same MLP
    (``depth`` hidden layers of width ``hidden``; 0 = linear)."""

    n_clients: int
    hidden: int
    depth: int = 2
    family: str = "mlp"

    def validate(self) -> None:
        if self.n_clients < 1:
            raise ValueError(f"cohort needs n_clients >= 1, got {self.n_clients}")
        if self.hidden < 1:
            raise ValueError(f"cohort needs hidden >= 1, got {self.hidden}")
        if self.depth < 0:
            raise ValueError(f"cohort needs depth >= 0, got {self.depth}")
        if self.family not in _FAMILIES:
            raise ValueError(
                f"unknown cohort model family {self.family!r} "
                f"(supported: {_FAMILIES})")


def resolve_cohorts(cfg) -> Tuple[CohortSpec, ...]:
    """``cfg.cohorts`` validated against ``cfg.n_clients``, or the single
    homogeneous cohort built from ``(hidden, mlp_depth)``."""
    if not getattr(cfg, "cohorts", None):
        return (CohortSpec(cfg.n_clients, cfg.hidden, cfg.mlp_depth),)
    cohorts = tuple(cfg.cohorts)
    for spec in cohorts:
        spec.validate()
    total = sum(s.n_clients for s in cohorts)
    if total != cfg.n_clients:
        raise ValueError(
            f"cohort sizes {[s.n_clients for s in cohorts]} sum to {total}, "
            f"but cfg.n_clients={cfg.n_clients}")
    return cohorts


class ClientModels:
    """Per-cohort stacked client parameters + cohort -> client index maps
    (cohort-major: cohort ``c`` owns clients ``[offset_c, offset_c + n_c)``)."""

    def __init__(self, cohorts: Sequence[CohortSpec], dim: int, n_classes: int):
        self.cohorts = tuple(cohorts)
        if not self.cohorts:
            raise ValueError("need at least one cohort")
        self.dim = dim
        self.n_classes = n_classes
        self.sizes = tuple(s.n_clients for s in self.cohorts)
        offs = np.concatenate([[0], np.cumsum(self.sizes)])
        self.offsets = tuple(int(o) for o in offs[:-1])
        self.n_clients = int(offs[-1])
        self.slices = tuple(slice(o, o + n)
                            for o, n in zip(self.offsets, self.sizes))

    @property
    def n_cohorts(self) -> int:
        return len(self.cohorts)

    @property
    def homogeneous(self) -> bool:
        return self.n_cohorts == 1

    def init_params(self, keys: torch.Tensor) -> List[Params]:
        """Per-cohort stacked params from ``(K, 2)`` keys, one a client in
        global client order (reference ``init_params``: each client's
        ``init_mlp`` on its own key)."""
        return [init_mlp(keys[sl], self.dim, self.n_classes, spec.hidden, spec.depth)
                for spec, sl in zip(self.cohorts, self.slices)]

    def split(self, arr) -> List:
        """Global per-client array ``(K, ...)`` -> per-cohort blocks."""
        if self.homogeneous:
            return [arr]
        return [arr[sl] for sl in self.slices]

    def concat(self, parts: Sequence[torch.Tensor]) -> torch.Tensor:
        """Per-cohort blocks -> global ``(K, ...)`` tensor."""
        parts = list(parts)
        if len(parts) == 1:
            return parts[0]
        return torch.cat(parts, dim=0)

    def shard_sizes(self, n_shards: int) -> Tuple[int, ...]:
        """Per-cohort client count on ONE shard; validates divisibility.

        The sharded engine splits every cohort block independently over
        the mesh "data" axis, so each cohort size must divide by the
        shard count (an equal per-cohort composition on every shard)."""
        for spec, n in zip(self.cohorts, self.sizes):
            if n % n_shards:
                raise ValueError(
                    f"cohort {spec} has {n} clients, not divisible over "
                    f"{n_shards} shards (every cohort must split evenly; "
                    "pick divisible cohort sizes or a narrower mesh)")
        return tuple(n // n_shards for n in self.sizes)
