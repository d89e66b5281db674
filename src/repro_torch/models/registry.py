"""Uniform model API over families (the port of
``repro.models.registry``): ``init`` and ``prefill`` are the entry
points.  Only the encoder-decoder family (whisper) is ported; any other
family raises NotImplementedError naming it.

``batch`` holds ``tokens`` (B, S) and ``audio_embeds`` (B, encoder_len,
d_model), as ``launch.specs.make_batch`` makes them.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.configs.registry import require_ported
from repro_torch.kernels.runtime import resolve_device
from repro_torch.models import common as cm
from repro_torch.models import whisper

_FAMILY = {"encdec": whisper}


def module_for(cfg: ModelConfig):
    return _FAMILY[require_ported(cfg).family]


def init(cfg: ModelConfig, generator: torch.Generator, device="cuda") -> cm.Params:
    """Random parameters of ``cfg`` on ``device`` (the card by default;
    raises without one), drawn from ``generator`` on the generator's own
    device: pass a CUDA generator to draw a full-width model on the
    card."""
    return module_for(cfg).init(cfg, generator, resolve_device(device))


def prefill(cfg: ModelConfig, params: cm.Params, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Full-sequence forward returning logits (B, S, V), on the device of
    the parameters."""
    mod = module_for(cfg)
    dev = params["embed"].device
    for name in ("tokens", "audio_embeds"):
        if batch[name].device != dev:
            raise ValueError(f"batch[{name!r}] is on {batch[name].device}, "
                             f"the parameters on {dev}")
    logits, _ = mod.forward(cfg, params, batch["tokens"], batch["audio_embeds"])
    return logits
