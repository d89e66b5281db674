"""Uniform model API over families (the port of
``repro.models.registry``): ``init``, ``param_axes`` (each parameter's
logical axes), ``loss_fn`` (the training loss) and ``prefill`` (the
full sequence), ``init_decode_cache``, ``cache_axes`` and
``decode_step`` (one token a step against a decode cache) are the entry
points.  The dense, MoE and VLM (``models/transformer.py``),
encoder-decoder (whisper), hybrid (jamba) and SSM (mamba2) families
have entries; any other family (the ResNet's, ``models/resnet.py``, an
image classifier with its own ``init`` / ``apply``) raises the
reference's ``ValueError`` naming it.

``batch`` holds ``tokens`` (B, S) and, for ``loss_fn``, ``labels`` (B,
S); the VLM family adds ``patch_embeds`` (B, n_patches, d_model) and the
encoder-decoder family ``audio_embeds`` (B, encoder_len, d_model), as
``launch.specs.make_batch`` makes them.  A decode cache is written in
place by ``decode_step``; whisper's cross-attention entries (``xk``,
``xv``) are the caller's to fill from ``whisper.precompute_cross_kv``.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple, Union

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.runtime import resolve_device
from repro_torch.models import common as cm
from repro_torch.models import jamba, mamba2, resnet, transformer, whisper

_FAMILY = {"dense": transformer, "moe": transformer, "vlm": transformer,
           "encdec": whisper, "hybrid": jamba, "ssm": mamba2}


def module_for(cfg: ModelConfig):
    try:
        return _FAMILY[cfg.family]
    except KeyError:
        raise ValueError(f"unknown family {cfg.family!r} for {cfg.name}") from None


def param_layout(cfg: ModelConfig) -> Tuple[cm.Specs, torch.dtype]:
    """``cfg``'s parameter specs and the type its parameters are held in:
    its family module's specs in ``cfg.param_dtype``, or the ResNet's in
    float32, the type the reference draws it in whatever the
    configuration says."""
    if cfg.family == "resnet":
        return resnet.param_specs(cfg), torch.float32
    return module_for(cfg).param_specs(cfg), cm.dtype_of(cfg.param_dtype)


def param_axes(cfg: ModelConfig) -> Dict[str, Any]:
    """The logical axis names of every parameter of ``cfg`` (e.g.
    ``("layers", "embed", "heads", None)``), a tree of the structure of
    its parameters: the axes the reference's ``registry.init`` returns,
    which ``launch/sharding.py`` maps onto a mesh."""
    return module_for(cfg).param_axes(cfg)


def init(cfg: ModelConfig, generator: torch.Generator, device="cuda") -> cm.Params:
    """Random parameters of ``cfg`` on ``device`` (the card by default;
    raises without one), drawn from ``generator`` on the generator's own
    device: pass a CUDA generator to draw a full-width model on the
    card."""
    return module_for(cfg).init(cfg, generator, resolve_device(device))


def loss_fn(cfg: ModelConfig, params: cm.Params, batch: Dict[str, Any],
            remat: bool = True) -> torch.Tensor:
    """The family's ``lm_loss``: the mean next-token cross-entropy (plus
    the MoE load-balance term), float32; ``remat`` checkpoints each layer
    under ``cfg.remat_policy``."""
    _check_device(params["embed"].device, **{f"batch[{n!r}]": t for n, t in batch.items()})
    return module_for(cfg).lm_loss(cfg, params, batch, remat=remat)


def prefill(cfg: ModelConfig, params: cm.Params, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Full-sequence forward returning logits (B, S, V) (the VLM's: B, P +
    S, V, its patch positions first, where the batch has
    ``patch_embeds``), on the device of the parameters."""
    mod = module_for(cfg)
    if cfg.family == "encdec":
        args = (batch["tokens"], batch["audio_embeds"])
    elif cfg.family == "vlm":
        args = (batch["tokens"], batch.get("patch_embeds"))
    else:
        args = (batch["tokens"],)
    _check_device(params["embed"].device, **{f"batch[{n!r}]": t for n, t in batch.items()})
    logits, _ = mod.forward(cfg, params, *args)
    return logits


def _check_device(dev: torch.device, **tensors: torch.Tensor) -> None:
    for name, t in tensors.items():
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, the parameters on {dev}")


def init_decode_cache(cfg: ModelConfig, batch: int, max_len: int,
                      device="cuda") -> Dict[str, torch.Tensor]:
    """A zero decode cache for ``batch`` sequences of up to ``max_len``
    tokens on ``device`` (the card by default; raises without one)."""
    return module_for(cfg).init_decode_cache(cfg, batch, max_len, resolve_device(device))


def cache_axes(cfg: ModelConfig, shape_name: str = "") -> Dict[str, Tuple]:
    return module_for(cfg).cache_axes(cfg, shape_name)


def decode_step(cfg: ModelConfig, params: cm.Params, cache: Dict[str, torch.Tensor],
                token: torch.Tensor, pos: Union[torch.Tensor, int]
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One token a sequence at position ``pos`` (a Python int or a 0-d
    integer tensor): the logits (B, V) float32 and the cache, updated in
    place and returned.  ``token``, the cache and a tensor ``pos`` must be
    on the parameters' device."""
    dev = params["embed"].device
    _check_device(dev, token=token, **{f"cache[{n!r}]": t for n, t in cache.items()})
    if isinstance(pos, torch.Tensor):
        _check_device(dev, pos=pos)
    return module_for(cfg).decode_step(cfg, params, cache, token, pos)
