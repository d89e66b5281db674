"""Carry the JAX package's model parameters into the port.

``params_from_numpy(cfg, tree)`` takes the reference's parameter tree
(nested dicts of arrays from ``repro.models.registry.init``, as numpy)
and returns the port's parameters with the same names, shapes and
dtypes, so the tests run both packages on the same weights.
``cache_from_numpy(cfg, cache)`` does the same for a decode cache (the
dict of arrays of ``repro.models.registry.init_decode_cache`` and
``decode_step``).  Nothing here imports the JAX package: the caller
converts its arrays to numpy.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.runtime import resolve_device
from repro_torch.models import common as cm
from repro_torch.models.registry import module_for, param_layout


def _tensor(a) -> torch.Tensor:
    """A numpy array as a tensor of the same dtype (a copy)."""
    a = np.array(a)
    if a.dtype.name == "bfloat16":  # ml_dtypes' bfloat16: carry the bits
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _convert(specs: cm.Specs, tree: Dict[str, Any], dtype, device, path=""):
    if set(specs) != set(tree):
        raise ValueError(f"parameter names differ at {path or 'the root'}: "
                         f"missing {sorted(set(specs) - set(tree))}, "
                         f"unexpected {sorted(set(tree) - set(specs))}")
    out = {}
    for name, s in specs.items():
        if isinstance(s, dict):
            out[name] = _convert(s, tree[name], dtype, device, f"{path}{name}.")
            continue
        t = _tensor(tree[name])
        if tuple(t.shape) != s[0]:
            raise ValueError(f"{path}{name}: shape {tuple(t.shape)}, expected {s[0]}")
        out[name] = t.to(device=device, dtype=dtype)
    return out


def params_from_numpy(cfg: ModelConfig, tree: Dict[str, Any], device="cuda") -> cm.Params:
    """The reference's parameter tree for ``cfg`` as the port's
    parameters on ``device``, in the type ``registry.param_layout`` gives
    (``cfg.param_dtype``; float32 for the ResNet)."""
    specs, dtype = param_layout(cfg)
    return _convert(specs, tree, dtype, resolve_device(device))


def cache_from_numpy(cfg: ModelConfig, cache: Dict[str, Any],
                     device="cuda") -> Dict[str, torch.Tensor]:
    """The reference's decode cache (whisper's ``k``, ``v``, ``xk``, ``xv``;
    jamba's ``k``, ``v``, ``ssm``, ``conv``; mamba2's ``ssm``, ``conv``; as
    numpy) as the port's on ``device``, each entry in the port's type for
    it; the batch and length come from ``cache["k"]``, else the batch from
    ``cache["ssm"]`` (a state of constant size)."""
    dev = resolve_device(device)
    if "k" in cache:
        B, max_len = np.shape(cache["k"])[1:3]
    elif "ssm" in cache:
        B, max_len = np.shape(cache["ssm"])[1], 0
    else:
        raise ValueError(f"cache entries {sorted(cache)} hold neither 'k' nor 'ssm'")
    want = module_for(cfg).init_decode_cache(cfg, B, max_len, torch.device("meta"))
    if set(cache) != set(want):
        raise ValueError(f"cache entries {sorted(cache)}, expected {sorted(want)}")
    out = {}
    for name, w in want.items():
        t = _tensor(cache[name])
        if t.shape != w.shape:
            raise ValueError(f"cache[{name!r}]: shape {tuple(t.shape)}, expected {tuple(w.shape)}")
        out[name] = t.to(device=dev, dtype=w.dtype)
    return out
