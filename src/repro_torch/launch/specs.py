"""Concrete input batches for the model entry points (the port's
``repro.launch.specs.make_batch`` for the ported families).

The audio frontend is a stub, as in the reference: ``audio_embeds``
arrive as precomputed frame embeddings.  Tokens and embeddings come from
``np.random.default_rng(seed)`` in the reference's order, so both
packages get identical inputs from the same seed.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.configs.registry import require_ported
from repro_torch.kernels.runtime import resolve_device


def make_batch(cfg: ModelConfig, batch: int, seq: int, seed: int = 0,
               device="cuda") -> Dict[str, torch.Tensor]:
    """``tokens`` (batch, seq) int32 and, for the encoder-decoder family,
    ``audio_embeds`` (batch, encoder_len, d_model) in the compute dtype, on
    ``device``."""
    require_ported(cfg)
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    out = {"tokens": torch.from_numpy(
        rng.integers(0, cfg.vocab_size, size=(batch, seq)).astype(np.int32)).to(dev)}
    if cfg.family == "encdec":
        audio = rng.normal(size=(batch, cfg.encoder_len, cfg.d_model))
        out["audio_embeds"] = torch.from_numpy(audio).to(
            device=dev, dtype=getattr(torch, cfg.compute_dtype))
    return out
