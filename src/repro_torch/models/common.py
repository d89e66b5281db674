"""Shared model machinery of the port (the subset of
``repro.models.common`` that the ported models run): parameter
initialisation with the reference's scales, RMS norm, the logits dtype,
and attention with the reference's routing to the flash kernel.

Parameters are nested dicts of tensors in the reference's layout (per
layer weights stacked on a leading layer axis), so the JAX package's
parameter trees carry across one to one (``models/convert.py``).
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple, Union

import torch

from repro_torch.kernels import ops

Params = Dict[str, Any]
# name -> (shape, scale or None, init) or a nested dict of the same
Specs = Dict[str, Any]


def spec(shape: Tuple[int, ...], scale: Optional[float] = None,
         init: str = "normal") -> Tuple[Tuple[int, ...], Optional[float], str]:
    """One parameter: ``init`` is "normal" (times ``scale``; by default
    ``1/sqrt(shape[-2])``, the reference's fan-in rule) or "zeros"."""
    return tuple(shape), scale, init


def init_params(specs: Specs, generator: torch.Generator, dtype: torch.dtype,
                device: torch.device) -> Params:
    """Draw every parameter of ``specs`` in order from ``generator`` (on
    the generator's device), as the reference's ``Builder`` scales them:
    a float32 standard normal times the scale, cast to ``dtype``.

    The fan-in of a normal parameter is ``shape[-2]`` as in the reference
    (``Builder.param``), which for a stacked ``(L, D, H, dh)`` projection
    is H, not D."""
    out: Params = {}
    for name, s in specs.items():
        if isinstance(s, dict):
            out[name] = init_params(s, generator, dtype, device)
            continue
        shape, scale, init = s
        if init == "zeros":
            out[name] = torch.zeros(shape, dtype=dtype, device=device)
            continue
        if scale is None:
            scale = 1.0 / math.sqrt(shape[-2] if len(shape) >= 2 else shape[-1])
        val = torch.randn(shape, generator=generator, device=generator.device,
                          dtype=torch.float32) * scale
        out[name] = val.to(device=device, dtype=dtype)
    return out


def tree_map(fn, params: Params) -> Params:
    """``fn`` applied to every tensor of a nested parameter dict (e.g.
    ``tree_map(lambda t: t.to("cuda"), params)``)."""
    return {n: tree_map(fn, t) if isinstance(t, dict) else fn(t)
            for n, t in params.items()}


def n_params(params: Params) -> int:
    return sum(n_params(t) if isinstance(t, dict) else t.numel() for t in params.values())


def dtype_of(name: str) -> torch.dtype:
    return getattr(torch, name)


def logits_dtype(cfg) -> torch.dtype:
    return torch.float32 if cfg.fp32_logits else dtype_of(cfg.compute_dtype)


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Normalise in float32 and scale by ``1 + weight``, back in x's type."""
    dt = x.dtype
    x = x.float()
    var = x.square().mean(-1, keepdim=True)
    return (x * torch.rsqrt(var + eps) * (1.0 + weight.float())).to(dt)


def flash_eligible(q: torch.Tensor, k: torch.Tensor, causal: bool,
                   q_offset: Union[torch.Tensor, int] = 0,
                   kv_len: Union[torch.Tensor, int, None] = None) -> bool:
    """The reference's test for the flash kernel (``common.attention``
    under ``ATTN_IMPL="pallas"``): plain causal self-attention over a
    sequence that is a multiple of 128, head dim a multiple of 8, no
    KV-length limit and a query offset of 0 as a Python int.  So a decode
    step (``kv_len`` set, a device ``q_offset``) never takes the kernel.
    The port's attention has no softcap or window argument (no ported
    model passes them), so those parts of the test hold."""
    Sq, dh = q.shape[1], q.shape[3]
    return (causal and kv_len is None and isinstance(q_offset, int) and q_offset == 0
            and Sq == k.shape[1] and Sq % 128 == 0 and dh % 8 == 0)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, q_offset: Union[torch.Tensor, int] = 0,
              kv_len: Union[torch.Tensor, int, None] = None,
              chunk_q: int = 0) -> torch.Tensor:
    """Grouped-query attention, q (B, Sq, H, dh), k and v (B, Sk, Hkv, dh).

    The query rows sit at positions ``q_offset + arange(Sq)`` (for the
    causal mask); ``kv_len`` keeps the keys at positions below it (the
    valid prefix of a decode cache).  Each may be a Python int or a 0-d
    integer tensor on q's device, which is read on the device only (no
    host sync).  An eligible call (:func:`flash_eligible`) goes to the
    flash kernel (``ops.flash_attention``).  Otherwise the plain path of
    the reference: float32 scores, masked to -1e30, softmax in float32, the
    output cast to q's type; ``chunk_q`` runs the query rows in chunks of
    that size."""
    if flash_eligible(q, k, causal, q_offset, kv_len):
        return ops.flash_attention(q, k, v, causal=True)
    B, Sq, H, dh = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    R = H // Hkv
    qg = q.reshape(B, Sq, Hkv, R, dh)
    scale = 1.0 / math.sqrt(dh)
    kf, vf = k.float(), v.float()
    k_pos = torch.arange(Sk, device=q.device)

    def block(q_blk: torch.Tensor, q_pos: torch.Tensor) -> torch.Tensor:
        s = torch.einsum("bqgrd,bkgd->bgrqk", q_blk.float(), kf) * scale
        mask = torch.ones((q_blk.shape[1], Sk), dtype=torch.bool, device=q.device)
        if causal:
            mask &= k_pos[None, :] <= q_pos[:, None]
        if kv_len is not None:
            mask &= k_pos[None, :] < kv_len
        s = torch.where(mask, s, torch.full((), -1e30, device=q.device))
        p = torch.softmax(s, dim=-1)
        return torch.einsum("bgrqk,bkgd->bqgrd", p, vf).to(q.dtype)

    q_positions = q_offset + torch.arange(Sq, device=q.device)
    if chunk_q and Sq % chunk_q == 0 and Sq > chunk_q:
        out = torch.cat([block(qg[:, i:i + chunk_q], q_positions[i:i + chunk_q])
                         for i in range(0, Sq, chunk_q)], dim=1)
    else:
        out = block(qg, q_positions)
    return out.reshape(B, Sq, H, dh)


def project(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``einsum("bsd,dhk->bshk")``: x (B, S, D) by w (D, H, dh)."""
    D, H, dh = w.shape
    return (x @ w.reshape(D, H * dh)).reshape(*x.shape[:-1], H, dh)


def project_out(o: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``einsum("bshk,hkd->bsd")``: o (B, S, H, dh) by w (H, dh, D)."""
    H, dh, D = w.shape
    return o.reshape(*o.shape[:-2], H * dh) @ w.reshape(H * dh, D)
