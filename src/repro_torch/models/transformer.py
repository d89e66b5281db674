"""Decoder-only transformer LM (the port of ``repro.models.transformer``),
covering the dense, MoE and VLM families:

- granite-3-2b / granite-3-8b / phi4-mini (dense GQA + RoPE + SwiGLU);
- gemma2-27b (alternating local/global attention, logit softcapping);
- kimi-k2 (MoE 384 experts top-8 + a shared expert), grok-1 (MoE 8
  experts top-2), through ``common.moe_ffn`` (its all-to-all branch
  under ``common.MOE_A2A_MESH``, as in the reference);
- internvl2 (a stub patch-embedding prefix + the dense LM).

Per-layer weights are stacked on a leading layer axis, as in the
reference; the layers run in a Python loop, each with its window a
Python int from :func:`layer_windows`.  So a layer whose attention meets
the flash routing's test (``common.flash_eligible``: no softcap, a
sequence that is a multiple of 128) takes the flash kernel, local
windows included; the reference's scanned window is a traced array and
never does (its result is the same attention).  ``forward(...,
remat=True)`` checkpoints each layer under ``cfg.remat_policy``.

Decode (``init_decode_cache``, ``cache_axes``, ``decode_step``) runs one
token a step against every layer's k/v cache, written in place; its
attention passes ``kv_len`` and never takes the kernel.
"""
from __future__ import annotations

import functools
from typing import Any, Dict, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import common as cm


def layer_windows(cfg: ModelConfig) -> np.ndarray:
    """Per-layer sliding windows; 0 = full attention.  Alternating
    configurations make the even layers local, the odd global."""
    if cfg.local_global_alternating and cfg.sliding_window:
        w = np.zeros(cfg.n_layers, np.int32)
        w[0::2] = cfg.sliding_window
        return w
    if cfg.sliding_window and not cfg.local_global_alternating:
        return np.full(cfg.n_layers, cfg.sliding_window, np.int32)
    return np.zeros(cfg.n_layers, np.int32)


def param_specs(cfg: ModelConfig) -> cm.Specs:
    """Every parameter's shape, scale and init, in the reference's order."""
    D, L, V = cfg.d_model, cfg.n_layers, cfg.padded_vocab
    H, Hkv, dh, F = cfg.n_heads, cfg.n_kv_heads, cfg.dh, cfg.d_ff
    s = cm.spec
    layers = {
        "ln1": s((L, D), init="zeros"),
        "wq": s((L, D, H, dh)),
        "wk": s((L, D, Hkv, dh)),
        "wv": s((L, D, Hkv, dh)),
        "wo": s((L, H, dh, D)),
        "ln2": s((L, D), init="zeros"),
    }
    if cfg.n_experts:
        E, Fe = cfg.n_experts, cfg.expert_d_ff
        layers.update(router=s((L, D, E)), w1=s((L, E, D, Fe)), w3=s((L, E, D, Fe)),
                      w2=s((L, E, Fe, D)))
        if cfg.n_shared_experts:
            Fs = cfg.n_shared_experts * Fe
            layers.update(sw1=s((L, D, Fs)), sw3=s((L, D, Fs)), sw2=s((L, Fs, D)))
    else:
        layers.update(w1=s((L, D, F)), w3=s((L, D, F)), w2=s((L, F, D)))
    return {
        "embed": s((V, D), scale=1.0),
        "layers": layers,
        "final_norm": s((D,), init="zeros"),
        "lm_head": s((V, D)),
    }


def param_axes(cfg: ModelConfig) -> Dict[str, Any]:
    """Every parameter's logical axis names, the tree the reference's
    ``init`` returns beside its parameters (the structure of
    :func:`param_specs`)."""
    att = ("layers", "embed", "heads", None)
    kv = ("layers", "embed", "kv", None)
    layers = {"ln1": ("layers", None), "wq": att, "wk": kv, "wv": kv,
              "wo": ("layers", "heads", None, "embed"), "ln2": ("layers", None)}
    if cfg.n_experts:
        ex_in, ex_out = ("layers", "experts", "embed", "ffn"), ("layers", "experts", "ffn", "embed")
        layers.update(router=("layers", "embed", None), w1=ex_in, w3=ex_in, w2=ex_out)
        if cfg.n_shared_experts:
            layers.update(sw1=("layers", "embed", "ffn"), sw3=("layers", "embed", "ffn"),
                          sw2=("layers", "ffn", "embed"))
    else:
        layers.update(w1=("layers", "embed", "ffn"), w3=("layers", "embed", "ffn"),
                      w2=("layers", "ffn", "embed"))
    return {"embed": ("vocab", "embed"), "layers": layers, "final_norm": (None,),
            "lm_head": ("vocab", "embed")}


def init(cfg: ModelConfig, generator: torch.Generator, device: torch.device) -> cm.Params:
    return cm.init_params(param_specs(cfg), generator, cm.dtype_of(cfg.param_dtype), device)


def _qkv(cfg: ModelConfig, lp: cm.Params, x: torch.Tensor, positions: torch.Tensor):
    h = cm.rms_norm(x, lp["ln1"], cfg.norm_eps)
    q, k, v = (cm.project(h, lp[w]) for w in ("wq", "wk", "wv"))
    return (cm.apply_rope(q, positions, cfg.rope_theta),
            cm.apply_rope(k, positions, cfg.rope_theta), v)


def _ffn(cfg: ModelConfig, lp: cm.Params, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x + the layer's FFN (dense SwiGLU, or the MoE plus its shared
    experts) and the MoE's load-balance loss (zero for a dense layer)."""
    h = cm.rms_norm(x, lp["ln2"], cfg.norm_eps)
    if not cfg.n_experts:
        return (cm.shard_batch(x + cm.swiglu(h, lp["w1"], lp["w3"], lp["w2"])),
                torch.zeros((), dtype=torch.float32, device=x.device))
    y, aux = cm.moe_ffn(h, lp["router"], lp["w1"], lp["w3"], lp["w2"], top_k=cfg.top_k,
                        capacity_factor=cfg.capacity_factor, d_ff=cfg.expert_d_ff)
    if cfg.n_shared_experts:
        y = y + cm.swiglu(h, lp["sw1"], lp["sw3"], lp["sw2"])
    return cm.shard_batch(x + y), aux


def _layer(cfg: ModelConfig, x: torch.Tensor, lp: cm.Params, window: int,
           positions: torch.Tensor, chunk_q: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """One layer over the whole sequence: (x, its load-balance loss)."""
    q, k, v = _qkv(cfg, lp, x, positions)
    score = torch.float32 if cfg.attn_f32 else cm.dtype_of(cfg.compute_dtype)
    o = cm.attention(q, k, v, causal=True, window=window, cap=cfg.attn_softcap,
                     chunk_q=chunk_q, score_dtype=score)
    return _ffn(cfg, lp, cm.shard_batch(x + cm.project_out(o, lp["wo"])))


def _logits(cfg: ModelConfig, params: cm.Params, x: torch.Tensor, dtype) -> torch.Tensor:
    x = cm.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return cm.softcap((x @ params["lm_head"].T).to(dtype), cfg.final_softcap)


def forward(cfg: ModelConfig, params: cm.Params, tokens: torch.Tensor,
            prefix_embeds: Optional[torch.Tensor] = None,
            remat: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens (B, S), after an optional prefix (B, P, D) of embeddings (the
    VLM's stub patch embeddings) -> logits (B, P + S, V) in the logits
    dtype, softcapped by ``final_softcap``, and the MoE layers' summed
    load-balance loss (float32)."""
    x = cm.embed(params["embed"], tokens, cm.dtype_of(cfg.compute_dtype))
    if prefix_embeds is not None:
        x = torch.cat([prefix_embeds.to(x.dtype), x], dim=1)
    S = x.shape[1]
    positions = torch.arange(S, device=x.device)
    chunk_q = 1024 if S >= 8192 else 0
    body = functools.partial(_layer, cfg, positions=positions, chunk_q=chunk_q)
    if remat:
        body = cm.remat_wrap(body, cfg.remat_policy)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for lp, w in zip(cm.layers(params["layers"]), layer_windows(cfg).tolist()):
        x, a = body(x, lp, w)
        aux = aux + a
    return _logits(cfg, params, x, cm.logits_dtype(cfg)), aux


def init_decode_cache(cfg: ModelConfig, batch: int, max_len: int,
                      device: torch.device) -> Dict[str, torch.Tensor]:
    """Zeros in ``param_dtype``: ``k``, ``v`` (L, B, max_len, Hkv, dh)."""
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.dh)
    dt = cm.dtype_of(cfg.param_dtype)
    return {"k": torch.zeros(shape, dtype=dt, device=device),
            "v": torch.zeros(shape, dtype=dt, device=device)}


def cache_axes(cfg: ModelConfig, shape_name: str = "") -> Dict[str, Tuple]:
    """Logical axes of the KV cache, the reference's tuples: kv heads
    sharded, or the sequence for batch-1 long-context decode."""
    if shape_name == "long_500k":
        ax = ("layers", None, "ctx", "kv", None)
    else:
        ax = ("layers", "batch", None, "kv", None)
    return {"k": ax, "v": ax}


def decode_step(cfg: ModelConfig, params: cm.Params, cache: Dict[str, torch.Tensor],
                token: torch.Tensor, pos: Union[torch.Tensor, int]
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One token a sequence: ``token`` (B, 1) at position ``pos`` (a
    Python int or a 0-d integer tensor on the parameters' device) -> the
    logits (B, V) float32, softcapped, and the cache.  Each layer's new
    k/v row is written at ``pos`` in place (``index_copy_``) and the same
    dict is returned; attention reads positions ``<= pos`` within the
    layer's window.  A device ``pos`` is never read on the host, so a
    step makes no host sync."""
    at = cm.position(pos, token.device)
    x = cm.embed(params["embed"], token, cm.dtype_of(cfg.compute_dtype))
    for i, (lp, w) in enumerate(zip(cm.layers(params["layers"]), layer_windows(cfg).tolist())):
        k_l, v_l = cache["k"][i], cache["v"][i]
        q, k, v = _qkv(cfg, lp, x, at)
        k_l.index_copy_(1, at, k.to(k_l.dtype))
        v_l.index_copy_(1, at, v.to(v_l.dtype))
        o = cm.attention(q, k_l, v_l, causal=False, window=w, cap=cfg.attn_softcap,
                         q_offset=pos, kv_len=pos + 1)
        x, _ = _ffn(cfg, lp, cm.shard_batch(x + cm.project_out(o, lp["wo"])))
    return _logits(cfg, params, x, torch.float32)[:, 0], cache


def lm_loss(cfg: ModelConfig, params: cm.Params, batch: Dict[str, Any],
            remat: bool = True) -> torch.Tensor:
    """Mean next-token cross-entropy plus ``cfg.router_aux_coef`` times the
    load-balance loss (float32); the VLM's prefix positions carry no
    loss."""
    prefix = batch.get("patch_embeds")
    logits, aux = forward(cfg, params, batch["tokens"], prefix_embeds=prefix, remat=remat)
    if prefix is not None:
        logits = logits[:, prefix.shape[1]:]
    return cm.next_token_ce(cfg, logits, batch["labels"]) + cfg.router_aux_coef * aux
