"""COMET: clustered co-distillation with per-cluster teachers."""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.fl.strategies.base import Strategy

__all__ = ["COMETStrategy"]


class COMETStrategy(Strategy):
    """COMET: cluster clients by soft-label similarity; each client
    distills from its cluster's teacher (the server from the mean).

    The clustering is the reference's k-means, operation for operation in
    host numpy on a float64 copy of the stack, with its seed ``1234 + t``,
    so both packages pick the same clusters from the same float32 values.
    The cluster teachers are averaged on the stack's device, in float32
    (the port leaves TF32 off)."""

    name = "comet"
    # scan_safe stays False: ``aggregate`` copies the stack to the host and
    # clusters it with a numpy Generator, which the analyzer's trace of
    # ``aggregate`` records
    analysis_variants = ({}, {"n_clusters": 3})

    def __init__(self, n_clusters: int = 2, **kw):
        super().__init__(**kw)
        self.c = n_clusters

    def aggregate(self, z, um, t):
        K = z.shape[0]
        n_clusters = min(self.c, K)
        rng = np.random.default_rng(1234 + t)
        feats = z.reshape(K, -1).to(torch.float64).cpu().numpy()
        # lightweight k-means
        cent = feats[rng.choice(K, n_clusters, replace=False)]
        for _ in range(10):
            d = ((feats[:, None] - cent[None]) ** 2).sum(-1)
            assign = d.argmin(1)
            for j in range(n_clusters):
                sel = feats[assign == j]
                if len(sel):
                    cent[j] = sel.mean(0)
        assign = torch.as_tensor(assign).to(z.device)
        # a float32 one-hot product: deterministic on the card, where an
        # index_add_ would sum by atomics in no fixed order
        one = torch.nn.functional.one_hot(assign, n_clusters).to(z.dtype)  # (K, c)
        csum = torch.tensordot(one, z, dims=([0], [0]))                    # (c, m, N)
        cnt = torch.clamp_min(one.sum(0), 1.0)[:, None, None]
        cteach = csum / cnt
        return torch.mean(z, dim=0), cteach[assign]                        # (K, m, N)
