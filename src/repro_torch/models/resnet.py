"""The CIFAR-style ResNet of ``repro.models.resnet`` (``init`` /
``apply``: the paper's own client/server model, Table III) and its MLP
client model (``init_mlp`` / ``apply_mlp``), batched over the client axis.

The ResNet's parameters are the reference's nested dict: ``stem`` (HWIO
3x3 conv weights), ``stem_scale``, ``stem_bias``, then a block
``s{s}b{i}`` of ``c1``, ``g1s``, ``g1b``, ``c2``, ``g2s``, ``g2b`` (and
``proj``, a 1x1 conv, where the width changes) per stage and depth, then
``head_w`` and ``head_b``; float32.  Its normalisation is GroupNorm, the
reference's documented stand-in for BatchNorm.  Its convolutions are
``F.conv2d`` (cuDNN on the card; the reference's are XLA's, outside any
Pallas kernel), padded by XLA's "SAME" rule, which is asymmetric for a
stride of 2.  The FL system never builds it (``fl/cohorts.py`` takes the
MLP alone), as in the reference.

The MLP's parameters are a dict with the reference's keys: ``w{i}`` of
shape ``(a, c)`` and ``b{i}`` of shape ``(c,)`` for one model, or
``(K, a, c)`` and ``(K, c)`` for a stack of K client models, which run
together with ``torch.bmm``.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core import prng
from repro_torch.kernels.runtime import resolve_device
from repro_torch.models import common as cm

__all__ = ["init", "apply", "init_mlp", "apply_mlp"]

Params = Dict[str, torch.Tensor]
Axes = Dict[str, Any]


def _same_pad(size: int, k: int, stride: int) -> Tuple[int, int]:
    """XLA's "SAME" padding of one spatial axis: ``ceil(size / stride)``
    outputs, the total ``max((out - 1) stride + k - size, 0)`` split with
    the smaller half first (a 3x3 stride-2 conv on 32 pads (0, 1))."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def _conv(x: torch.Tensor, w: torch.Tensor, stride: int = 1) -> torch.Tensor:
    """x (B, C, H, W) by HWIO weights ``w``, "SAME" padded."""
    kh, kw = w.shape[:2]
    ph, pw = _same_pad(x.shape[2], kh, stride), _same_pad(x.shape[3], kw, stride)
    x = F.pad(x, (pw[0], pw[1], ph[0], ph[1]))
    return F.conv2d(x, w.permute(3, 2, 0, 1), stride=stride)


def _gn(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
        groups: int = 8) -> torch.Tensor:
    """GroupNorm over ``min(groups, C)`` groups of contiguous channels:
    float32 statistics (biased variance, eps 1e-5), back in x's type."""
    B, C, H, W = x.shape
    g = min(groups, C)
    xg = x.reshape(B, g, C // g, H, W).float()
    var, mean = torch.var_mean(xg, dim=(2, 3, 4), correction=0, keepdim=True)
    xg = (xg - mean) * torch.rsqrt(var + 1e-5)
    return (xg.reshape(B, C, H, W) * scale[:, None, None] + bias[:, None, None]).to(x.dtype)


def _specs(depth: int, n_classes: int, in_channels: int,
           width: int) -> Tuple[Dict[str, Any], Axes]:
    """``(specs, axes)`` of the reference's tree, in its order: specs as
    ``common.init_params`` takes them, axes the reference's logical axes."""
    if (depth - 2) % 6:
        raise ValueError(f"a CIFAR ResNet has depth 6n + 2, not {depth}")
    conv_axes = (None, None, None, "ffn")
    specs: Dict[str, Any] = {}
    axes: Axes = {}

    def conv(tree, ax, name, k, cin, cout):
        tree[name] = cm.spec((k, k, cin, cout), math.sqrt(2.0 / (k * k * cin)))
        ax[name] = conv_axes

    def norm(tree, ax, s, b, c):
        tree[s], tree[b] = cm.spec((c,), init="ones"), cm.spec((c,), init="zeros")
        ax[s] = ax[b] = ("ffn",)

    conv(specs, axes, "stem", 3, in_channels, width)
    norm(specs, axes, "stem_scale", "stem_bias", width)
    cin = width
    for s, mult in enumerate((1, 2, 4)):
        cout = width * mult
        for i in range((depth - 2) // 6):
            bs, ba = {}, {}
            specs[f"s{s}b{i}"], axes[f"s{s}b{i}"] = bs, ba
            conv(bs, ba, "c1", 3, cin, cout)
            norm(bs, ba, "g1s", "g1b", cout)
            conv(bs, ba, "c2", 3, cout, cout)
            norm(bs, ba, "g2s", "g2b", cout)
            if cin != cout:
                conv(bs, ba, "proj", 1, cin, cout)
            cin = cout
    specs["head_w"] = cm.spec((cin, n_classes), 1.0 / math.sqrt(cin))
    specs["head_b"] = cm.spec((n_classes,), init="zeros")
    axes["head_w"], axes["head_b"] = ("ffn", "vocab"), ("vocab",)
    return specs, axes


def init(generator: torch.Generator, depth: int = 20, n_classes: int = 10,
         in_channels: int = 3, width: int = 16, device="cuda") -> Tuple[Params, Axes]:
    """ResNet-(6n+2) with widths w, 2w, 4w: ``(params, axes)``, float32 on
    ``device`` (the card by default; raises without one), drawn from
    ``generator`` on its own device.  Conv weights He-normal
    (``sqrt(2 / (k k cin))``), the head ``1/sqrt(4w)``, norms ones and
    zeros, biases zeros: the reference's scales and axes; the numbers
    differ from ``jax.random``'s."""
    specs, axes = _specs(depth, n_classes, in_channels, width)
    return cm.init_params(specs, generator, torch.float32, resolve_device(device)), axes


def param_specs(cfg) -> Dict[str, Any]:
    """The tree's shapes and initialisers for a ResNet configuration
    (``models/registry.param_layout``): depth ``n_layers``, width
    ``d_model``, ``vocab_size`` classes and 3 input channels, as the
    reference's ``resnet.init`` takes them."""
    return _specs(cfg.n_layers, cfg.vocab_size, 3, cfg.d_model)[0]


def apply(params: Params, images: torch.Tensor, depth: int = 20) -> torch.Tensor:
    """images (B, H, W, C) -> logits (B, n_classes), as the reference
    computes them (the convolutions run channels-first inside)."""
    n = (depth - 2) // 6
    x = _conv(images.permute(0, 3, 1, 2), params["stem"])
    x = torch.relu(_gn(x, params["stem_scale"], params["stem_bias"]))
    for s in range(3):
        for i in range(n):
            p = params[f"s{s}b{i}"]
            stride = 2 if (s > 0 and i == 0) else 1
            h = torch.relu(_gn(_conv(x, p["c1"], stride), p["g1s"], p["g1b"]))
            h = _gn(_conv(h, p["c2"]), p["g2s"], p["g2b"])
            sc = _conv(x, p["proj"], stride) if "proj" in p else x
            x = torch.relu(h + sc)
    return x.mean(dim=(2, 3)) @ params["head_w"] + params["head_b"]


def init_mlp(keys: torch.Tensor, in_dim: int, n_classes: int, hidden: int = 128,
             depth: int = 2) -> Params:
    """Small MLP classifier, the FL runs' client and server model
    (reference ``init_mlp``): for each layer ``key, k1 = split(key)``,
    He-normal weights ``normal(k1, (a, c)) * sqrt(2 / a)`` and zero
    biases, from the reference's key stream (:mod:`repro_torch.core.prng`).
    ``keys`` is one ``(2,)`` key or a ``(..., 2)`` batch, which gives
    stacked models with the batch's leading axes (the reference's
    ``vmap`` over keys), on the keys' device."""
    params: Params = {}
    lead = keys.shape[:-1]
    dims = [in_dim] + [hidden] * depth + [n_classes]
    for i, (a, c) in enumerate(zip(dims[:-1], dims[1:])):
        pair = prng.split(keys)
        keys, k1 = pair[..., 0, :], pair[..., 1, :]
        params[f"w{i}"] = prng.normal(k1, (a, c)) * math.sqrt(2.0 / a)
        params[f"b{i}"] = torch.zeros(lead + (c,), device=keys.device)
    return params


def apply_mlp(params: Params, x: torch.Tensor) -> torch.Tensor:
    """Logits.  One model: ``x (B, d) -> (B, N)``.  A stack of K models:
    ``x (K, B, d)`` per client, or ``x (B, d)`` shared by all clients,
    ``-> (K, B, N)``."""
    n = sum(1 for k in params if k.startswith("w"))
    for i in range(n):
        w, b = params[f"w{i}"], params[f"b{i}"]
        if w.dim() == 3:
            if x.dim() == 2:
                x = x.expand(w.shape[0], -1, -1)
            x = torch.bmm(x, w) + b.unsqueeze(1)
        else:
            x = x @ w + b
        if i < n - 1:
            x = torch.relu(x)
    return x
