"""Jamba-style hybrid (arXiv:2403.19887), the port of
``repro.models.jamba``: attention and Mamba2 mixers 1:7, with an MoE FFN
on every other sublayer.

The stack is ``n_layers / attn_layer_period`` blocks of 8 sublayers:
sublayer 0 is GQA attention with RoPE, 1..7 are Mamba2 mixers
(``models/mamba2.py``); each is followed by an FFN, dense SwiGLU on even
sublayers and the sort-based MoE (16 experts, top-2) on odd ones.  The
prefill's attention is plain causal self-attention, eligible for the
flash kernel when the sequence is a multiple of 128 (head dim 128 at full
width); decode passes ``kv_len`` and never takes it.

Decode (``init_decode_cache``, ``cache_axes``, ``decode_step``) runs one
token a step against the attention layers' k/v cache and the mixers'
recurrent and conv states, all written in place.

``lm_loss`` is the next-token cross-entropy plus ``router_aux_coef``
times the MoE sublayers' load-balance loss; ``forward(..., remat=True)``
checkpoints each block under ``cfg.remat_policy``.
"""
from __future__ import annotations

import functools
from typing import Any, Dict, Optional, Tuple, Union

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import common as cm
from repro_torch.models import mamba2 as m2


def _block_counts(cfg: ModelConfig) -> Tuple[int, int, int, int]:
    """(blocks, mixers a block, dense FFNs a block, MoE FFNs a block)."""
    period = cfg.attn_layer_period
    n_moe = period // cfg.moe_every
    return cfg.n_layers // period, period - 1, period - n_moe, n_moe


def param_specs(cfg: ModelConfig) -> cm.Specs:
    """Every parameter's shape, scale and init, in the reference's order.
    The mixers are stacked (nb, n_mamba, ...), each scaled by the fan-in
    of the reference's flat (nb * n_mamba, ...) shape; their norms
    ``mamba.ln`` are zeros, appended last."""
    D, V = cfg.d_model, cfg.padded_vocab
    H, Hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.dh
    F, E, Fe = cfg.d_ff, cfg.n_experts, cfg.expert_d_ff
    nb, n_mamba, n_dense, n_moe = _block_counts(cfg)
    s = cm.spec
    mamba = {}
    for name, (shape, scale, init) in m2.mixer_specs(cfg, nb * n_mamba).items():
        if init == "normal" and scale is None:
            scale = cm.fan_in_scale(shape)
        mamba[name] = s((nb, n_mamba) + shape[1:], scale, init)
    mamba["ln"] = s((nb, n_mamba, D), init="zeros")
    blocks = {
        "attn_ln": s((nb, D), init="zeros"),
        "wq": s((nb, D, H, dh)),
        "wk": s((nb, D, Hkv, dh)),
        "wv": s((nb, D, Hkv, dh)),
        "wo": s((nb, H, dh, D)),
        "mamba": mamba,
        "ffn_ln": s((nb, n_dense, D), init="zeros"),
        "w1": s((nb, n_dense, D, F)),
        "w3": s((nb, n_dense, D, F)),
        "w2": s((nb, n_dense, F, D)),
        "moe_ln": s((nb, n_moe, D), init="zeros"),
        "router": s((nb, n_moe, D, E)),
        "mw1": s((nb, n_moe, E, D, Fe)),
        "mw3": s((nb, n_moe, E, D, Fe)),
        "mw2": s((nb, n_moe, E, Fe, D)),
    }
    return {
        "embed": s((V, D), scale=1.0),
        "blocks": blocks,
        "final_norm": s((D,), init="zeros"),
        "lm_head": s((V, D)),
    }


def param_axes(cfg: ModelConfig) -> Dict[str, Any]:
    """Every parameter's logical axis names, the tree the reference's
    ``init`` returns beside its parameters (the structure of
    :func:`param_specs`): a mixer's are the Mamba2 mixer's with its flat
    layer axis split into ("layers", None)."""
    mamba = {n: ("layers", None) + ax[1:] for n, ax in m2.mixer_axes().items()}
    mamba["ln"] = ("layers", None, None)
    sub = ("layers", None)
    blocks = {
        "attn_ln": ("layers", None), "wq": ("layers", "embed", "heads", None),
        "wk": ("layers", "embed", "kv", None), "wv": ("layers", "embed", "kv", None),
        "wo": ("layers", "heads", None, "embed"), "mamba": mamba,
        "ffn_ln": sub + (None,), "w1": sub + ("embed", "ffn"), "w3": sub + ("embed", "ffn"),
        "w2": sub + ("ffn", "embed"), "moe_ln": sub + (None,),
        "router": sub + ("embed", None), "mw1": sub + ("experts", "embed", "ffn"),
        "mw3": sub + ("experts", "embed", "ffn"), "mw2": sub + ("experts", "ffn", "embed"),
    }
    return {"embed": ("vocab", "embed"), "blocks": blocks, "final_norm": (None,),
            "lm_head": ("vocab", "embed")}


def init(cfg: ModelConfig, generator: torch.Generator, device: torch.device) -> cm.Params:
    return cm.init_params(param_specs(cfg), generator, cm.dtype_of(cfg.param_dtype), device)


def _ffn(cfg: ModelConfig, fp: cm.Params, x: torch.Tensor,
         routing: Optional[list] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """x + the FFN of weights ``fp`` (one of :func:`_ffns`: dense SwiGLU or
    the MoE) and its auxiliary loss."""
    if "router" not in fp:
        h = cm.rms_norm(x, fp["ffn_ln"], cfg.norm_eps)
        return (cm.shard_batch(x + cm.swiglu(h, fp["w1"], fp["w3"], fp["w2"])),
                torch.zeros((), dtype=torch.float32, device=x.device))
    h = cm.rms_norm(x, fp["moe_ln"], cfg.norm_eps)
    y, aux = cm.moe_ffn(h, fp["router"], fp["mw1"], fp["mw3"], fp["mw2"],
                        top_k=cfg.top_k, capacity_factor=cfg.capacity_factor,
                        routing=routing, d_ff=cfg.expert_d_ff)
    return cm.shard_batch(x + y), aux


def _ffns(cfg: ModelConfig, bp: cm.Params) -> list:
    """The FFN weights after each of the block's sublayers, in order: dense
    on even sublayers, MoE on odd (views by ``common.layers``)."""
    dense = cm.layers({n: bp[n] for n in ("ffn_ln", "w1", "w3", "w2")})
    moe = cm.layers({n: bp[n] for n in ("moe_ln", "router", "mw1", "mw3", "mw2")})
    return [next(dense) if sub % cfg.moe_every == 0 else next(moe)
            for sub in range(cfg.attn_layer_period)]


def _qkv(cfg: ModelConfig, bp: cm.Params, x: torch.Tensor, positions: torch.Tensor):
    h = cm.rms_norm(x, bp["attn_ln"], cfg.norm_eps)
    q, k, v = (cm.project(h, bp[w]) for w in ("wq", "wk", "wv"))
    return (cm.apply_rope(q, positions, cfg.rope_theta),
            cm.apply_rope(k, positions, cfg.rope_theta), v)


def _mixers(bp: cm.Params):
    """(j, the mixer's parameters, its norm) for the block's mixers."""
    for j, mp in enumerate(cm.layers(bp["mamba"])):
        yield j, mp, mp.pop("ln")


def _block(cfg: ModelConfig, x: torch.Tensor, bp: cm.Params, positions: torch.Tensor,
           chunk_q: int, routing: Optional[list]) -> Tuple[torch.Tensor, torch.Tensor]:
    """One block over the whole sequence: (x, its MoE sublayers' summed
    load-balance loss)."""
    ffns = _ffns(cfg, bp)
    q, k, v = _qkv(cfg, bp, x, positions)
    x = cm.shard_batch(x + cm.project_out(cm.attention(q, k, v, causal=True, chunk_q=chunk_q),
                                          bp["wo"]))
    x, aux = _ffn(cfg, ffns[0], x, routing)
    for j, mp, ln in _mixers(bp):
        x = cm.shard_batch(x + m2.mixer_forward(cfg, mp, cm.rms_norm(x, ln, cfg.norm_eps)))
        x, a = _ffn(cfg, ffns[j + 1], x, routing)
        aux = aux + a
    return x, aux


def forward(cfg: ModelConfig, params: cm.Params, tokens: torch.Tensor,
            routing: Optional[list] = None,
            remat: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens (B, S) -> logits (B, S, V) in the logits dtype and the sum of
    the MoE sublayers' load-balance losses (float32).  ``routing``, if a
    list, receives each MoE sublayer's routing in order
    (``common.moe_ffn``; again in the backward's recompute under
    ``remat``)."""
    x = cm.embed(params["embed"], tokens, cm.dtype_of(cfg.compute_dtype))
    S = x.shape[1]
    positions = torch.arange(S, device=x.device)
    chunk_q = 1024 if S >= 8192 else 0
    body = functools.partial(_block, cfg, positions=positions, chunk_q=chunk_q,
                             routing=routing)
    if remat:
        body = cm.remat_wrap(body, cfg.remat_policy)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for bp in cm.layers(params["blocks"]):
        x, a = body(x, bp)
        aux = aux + a
    x = cm.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return (x @ params["lm_head"].T).to(cm.logits_dtype(cfg)), aux


def init_decode_cache(cfg: ModelConfig, batch: int, max_len: int,
                      device: torch.device) -> Dict[str, torch.Tensor]:
    """Zeros: ``k``, ``v`` (nb, B, max_len, Hkv, dh) in ``param_dtype``;
    ``ssm`` (nb, n_mamba, B, nh, N, hd) float32; ``conv`` (nb, n_mamba, B,
    k - 1, conv_dim) in ``param_dtype``."""
    nb, n_mamba, _, _ = _block_counts(cfg)
    kv = (nb, batch, max_len, cfg.n_kv_heads, cfg.dh)
    dt = cm.dtype_of(cfg.param_dtype)
    ssm = m2.mixer_cache(cfg, nb * n_mamba, batch, device)
    return {
        "k": torch.zeros(kv, dtype=dt, device=device),
        "v": torch.zeros(kv, dtype=dt, device=device),
        "ssm": ssm["ssm"].reshape((nb, n_mamba) + ssm["ssm"].shape[1:]),
        "conv": ssm["conv"].reshape((nb, n_mamba) + ssm["conv"].shape[1:]),
    }


def cache_axes(cfg: ModelConfig, shape_name: str = "") -> Dict[str, Tuple]:
    """Logical axes of each cache entry, the reference's tuples."""
    if shape_name == "long_500k":
        kv, bt = ("layers", None, "ctx", "kv", None), None
    else:
        kv, bt = ("layers", "batch", None, "kv", None), "batch"
    return {"k": kv, "v": kv, "ssm": ("layers", None, bt, "heads", None, None),
            "conv": ("layers", None, bt, None, "ffn")}


def decode_step(cfg: ModelConfig, params: cm.Params, cache: Dict[str, torch.Tensor],
                token: torch.Tensor, pos: Union[torch.Tensor, int]
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One token a sequence: ``token`` (B, 1) at position ``pos`` (a
    Python int or a 0-d integer tensor on the parameters' device) -> the
    logits (B, V) float32 and the cache.  The attention layers' new k/v
    rows are written at ``pos`` (``index_copy_``) and the mixers' states
    replaced, all in place; the same dict is returned.  A device ``pos`` is
    never read on the host, so a step makes no host sync."""
    at = cm.position(pos, token.device)
    x = cm.embed(params["embed"], token, cm.dtype_of(cfg.compute_dtype))
    for b, bp in enumerate(cm.layers(params["blocks"])):
        k_l, v_l = cache["k"][b], cache["v"][b]
        q, k, v = _qkv(cfg, bp, x, at)
        k_l.index_copy_(1, at, k.to(k_l.dtype))
        v_l.index_copy_(1, at, v.to(v_l.dtype))
        o = cm.attention(q, k_l, v_l, causal=False, q_offset=pos, kv_len=pos + 1)
        x = cm.shard_batch(x + cm.project_out(o, bp["wo"]))
        ffns = _ffns(cfg, bp)
        x, _ = _ffn(cfg, ffns[0], x)
        for j, mp, ln in _mixers(bp):
            out, ssm, conv = m2.mixer_decode(cfg, mp, cache["ssm"][b, j], cache["conv"][b, j],
                                             cm.rms_norm(x, ln, cfg.norm_eps))
            cache["ssm"][b, j].copy_(ssm)
            cache["conv"][b, j].copy_(conv)
            x = cm.shard_batch(x + out)
            x, _ = _ffn(cfg, ffns[j + 1], x)
    x = cm.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return (x @ params["lm_head"].T).to(torch.float32)[:, 0], cache


def lm_loss(cfg: ModelConfig, params: cm.Params, batch: Dict[str, Any],
            remat: bool = True) -> torch.Tensor:
    """Mean next-token cross-entropy plus ``cfg.router_aux_coef`` times the
    load-balance loss (float32)."""
    logits, aux = forward(cfg, params, batch["tokens"], remat=remat)
    return cm.next_token_ce(cfg, logits, batch["labels"]) + cfg.router_aux_coef * aux
