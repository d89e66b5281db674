"""Strategy protocol: the distillation method's aggregation (counterpart of
``repro.fl.strategies.base``, host-loop subset).

A Strategy owns how client soft-labels are aggregated into a teacher and
what the method pays per value on the wire.  The reference's hooks for
payload transforms, upload gating and the fixed-shape/sharded
aggregation contract serve methods and engines that are not ported yet.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

__all__ = ["Strategy"]


class Strategy:
    """Distillation-method-specific behavior.  Subclasses override
    :meth:`aggregate`."""

    name = "base"
    uses_cache = False
    uplink_bits = 32.0
    downlink_bits = 32.0

    def __init__(self, **kw):
        self.opts = kw

    def aggregate(self, z_clients: torch.Tensor, t
                  ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """Participants' ``(n_part, m, N)`` soft-labels -> the server's
        ``(m, N)`` teacher, and per-client teachers for personalized
        methods (None here)."""
        raise NotImplementedError
