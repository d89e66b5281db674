"""Input specs and concrete input batches for the model entry points
(the port of ``repro.launch.specs``).

``input_specs`` (``train_specs``, ``decode_specs``) gives the
reference's shapes and dtypes as ``(shape, dtype)`` pairs, allocating
nothing: the dry run's stand-ins for a step's inputs.  ``make_batch``
materialises a small concrete batch.

The vision and audio frontends are stubs, as in the reference:
``patch_embeds`` and ``audio_embeds`` arrive as precomputed patch and
frame embeddings.  Tokens and embeddings come from
``np.random.default_rng(seed)`` in the reference's order, so both
packages get identical inputs from the same seed.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch

from repro_torch.configs.base import SHAPES_BY_NAME, InputShape, ModelConfig
from repro_torch.kernels.runtime import resolve_device

TensorSpec = Tuple[Tuple[int, ...], torch.dtype]


def train_specs(cfg: ModelConfig, batch: int, seq: int) -> Dict[str, TensorSpec]:
    """``tokens`` and ``labels`` (batch, seq) int32, and the family's stub
    frontend input in the compute dtype (:func:`stub_shape`)."""
    specs = {"tokens": ((batch, seq), torch.int32), "labels": ((batch, seq), torch.int32)}
    stub = stub_shape(cfg, batch)
    if stub:
        specs[stub[0]] = (stub[1], getattr(torch, cfg.compute_dtype))
    return specs


def decode_specs(cfg: ModelConfig, batch: int, seq: int) -> Tuple[Any, ...]:
    """(token, pos, cache) specs of a decode step: token (batch, 1) int32,
    pos () int32, and each entry of ``registry.init_decode_cache(cfg,
    batch, seq)``, made on the meta device so that a multi-terabyte cache
    is never allocated."""
    from repro_torch.models import registry

    cache = registry.init_decode_cache(cfg, batch, seq, device="meta")
    return (((batch, 1), torch.int32), ((), torch.int32),
            {n: (tuple(t.shape), t.dtype) for n, t in cache.items()})


def input_specs(cfg: ModelConfig, shape: InputShape | str):
    """``train_specs`` for a train or prefill shape, ``decode_specs`` for a
    decode shape, at its global batch and sequence length."""
    if isinstance(shape, str):
        shape = SHAPES_BY_NAME[shape]
    if shape.mode in ("train", "prefill"):
        return train_specs(cfg, shape.global_batch, shape.seq_len)
    return decode_specs(cfg, shape.global_batch, shape.seq_len)


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
