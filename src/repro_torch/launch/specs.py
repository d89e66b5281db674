"""Concrete input batches for the model entry points (the port's
``repro.launch.specs.make_batch``).

The vision and audio frontends are stubs, as in the reference:
``patch_embeds`` and ``audio_embeds`` arrive as precomputed patch and
frame embeddings.  Tokens and embeddings come from
``np.random.default_rng(seed)`` in the reference's order, so both
packages get identical inputs from the same seed.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.runtime import resolve_device


def make_batch(cfg: ModelConfig, batch: int, seq: int, seed: int = 0,
               device="cuda") -> Dict[str, torch.Tensor]:
    """``tokens`` (batch, seq) int32 and, for the VLM family,
    ``patch_embeds`` (batch, n_patches, d_model), for the encoder-decoder
    family ``audio_embeds`` (batch, encoder_len, d_model), both standard
    normals in the compute dtype, on ``device``.  (The training labels are
    the tokens, as in the reference's batch.)"""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    out = {"tokens": torch.from_numpy(
        rng.integers(0, cfg.vocab_size, size=(batch, seq)).astype(np.int32)).to(dev)}
    stub = stub_shape(cfg, batch)
    if stub:
        emb = rng.normal(size=stub[1])
        out[stub[0]] = torch.from_numpy(emb).to(device=dev, dtype=getattr(torch, cfg.compute_dtype))
    return out


def stub_shape(cfg: ModelConfig, batch: int):
    """``(name, shape)`` of the stub frontend's input that ``cfg``'s family
    takes: the VLM's ``patch_embeds`` (batch, n_patches, d_model), the
    encoder-decoder's ``audio_embeds`` (batch, encoder_len, d_model); None
    for the other families."""
    stub = {"vlm": ("patch_embeds", cfg.n_patches),
            "encdec": ("audio_embeds", cfg.encoder_len)}.get(cfg.family)
    return None if stub is None else (stub[0], (batch, stub[1], cfg.d_model))
