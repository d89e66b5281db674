"""CFD (Sattler et al. 2020): quantized uplink soft-labels."""
from __future__ import annotations

import torch

from repro_torch.compress.codecs import QuantCodec
from repro_torch.fl.strategies.base import Strategy

__all__ = ["CFDStrategy"]


class CFDStrategy(Strategy):
    """CFD: quantized uplink soft-labels (``b_up`` bits), plain averaging.

    The quantizer is :class:`repro_torch.compress.codecs.QuantCodec`
    (per-row min-max, simplex renormalization), so ``transmit`` launches
    the quantize-dequantize kernel on a CUDA stack.  Bytes are charged
    through ``uplink_bits`` (``b_up`` bits a value, Table V); the
    engine's uplink codec stays the identity unless the caller sets one.
    """

    name = "cfd"
    scan_safe = True  # transmit is a fixed-shape kernel call; mean aggregation
    analysis_variants = ({}, {"b_up": 8})

    def __init__(self, b_up: int = 1, b_down: int = 32, **kw):
        super().__init__(**kw)
        self.uplink_bits = float(b_up)
        self.downlink_bits = float(b_down)
        self.b_up = b_up
        self._codec = QuantCodec(b_up)

    def transmit(self, z, key=None):
        return self._codec.roundtrip(z)

    def aggregate(self, z, um, t):
        return torch.mean(z, dim=0), None
