"""Whisper-large-v3-style encoder-decoder (arXiv:2212.04356), the port of
``repro.models.whisper``: the full-sequence forward and the KV-cache
decode step.

The mel-spectrogram and conv feature extractor is a stub, as in the
reference: the encoder takes precomputed audio frame embeddings
(B, encoder_len, d_model).  The backbone: a bidirectional encoder, a
causal decoder with cross-attention, learned positions, a GELU MLP (tanh
approximation, ``jax.nn.gelu``'s default) and multi-head attention
(kv = heads).  The decoder's causal self-attention is eligible for the
flash kernel at every layer when the decoder length is a multiple of
128; the encoder's and the cross-attention stay on the plain path, as in
the reference.

Decode (``init_decode_cache``, ``precompute_cross_kv``, ``cache_axes``,
``decode_step``) runs one token a step against a cache of every layer's
self-attention keys and values and the encoder's cross-attention keys
and values, which the caller fills from ``precompute_cross_kv``.  Its
attention passes ``kv_len``, so it never takes the flash kernel, as in
the reference.  ``decode_step`` writes the cache in place.

``lm_loss`` is the next-token cross-entropy of the forward's logits;
``forward(..., remat=True)`` checkpoints each encoder and decoder layer
under ``cfg.remat_policy`` (``common.remat_wrap``).
"""
from __future__ import annotations

import functools
from typing import Any, Dict, Tuple, Union

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models import common as cm


def _max_pos(cfg: ModelConfig) -> int:
    # decoder learned positions; sized as the reference sizes them
    return 128 if cfg.vocab_size <= 512 else 32_768


def param_specs(cfg: ModelConfig) -> cm.Specs:
    """Every parameter's shape, scale and init, in the reference's order."""
    D, V = cfg.d_model, cfg.padded_vocab
    H, Hkv, dh, Fd = cfg.n_heads, cfg.n_kv_heads, cfg.dh, cfg.d_ff
    Le, Ld = cfg.n_encoder_layers, cfg.n_layers
    s = cm.spec
    encoder = {
        "ln1": s((Le, D), init="zeros"),
        "wq": s((Le, D, H, dh)),
        "wk": s((Le, D, Hkv, dh)),
        "wv": s((Le, D, Hkv, dh)),
        "wo": s((Le, H, dh, D)),
        "ln2": s((Le, D), init="zeros"),
        "mlp_in": s((Le, D, Fd)),
        "mlp_out": s((Le, Fd, D)),
    }
    decoder = {
        "ln1": s((Ld, D), init="zeros"),
        "wq": s((Ld, D, H, dh)),
        "wk": s((Ld, D, Hkv, dh)),
        "wv": s((Ld, D, Hkv, dh)),
        "wo": s((Ld, H, dh, D)),
        "lnx": s((Ld, D), init="zeros"),
        "xwq": s((Ld, D, H, dh)),
        "xwk": s((Ld, D, Hkv, dh)),
        "xwv": s((Ld, D, Hkv, dh)),
        "xwo": s((Ld, H, dh, D)),
        "ln2": s((Ld, D), init="zeros"),
        "mlp_in": s((Ld, D, Fd)),
        "mlp_out": s((Ld, Fd, D)),
    }
    return {
        "embed": s((V, D), scale=1.0),
        "enc_pos": s((cfg.encoder_len, D), scale=0.02),
        "dec_pos": s((_max_pos(cfg), D), scale=0.02),
        "encoder": encoder,
        "enc_final_norm": s((D,), init="zeros"),
        "decoder": decoder,
        "final_norm": s((D,), init="zeros"),
        "lm_head": s((V, D)),
    }


def param_axes(cfg: ModelConfig) -> Dict[str, Any]:
    """Every parameter's logical axis names, the tree the reference's
    ``init`` returns beside its parameters (the structure of
    :func:`param_specs`)."""
    ln = ("layers", None)
    q, kv = ("layers", "embed", "heads", None), ("layers", "embed", "kv", None)
    o = ("layers", "heads", None, "embed")
    mlp = {"mlp_in": ("layers", "embed", "ffn"), "mlp_out": ("layers", "ffn", "embed")}
    encoder = {"ln1": ln, "wq": q, "wk": kv, "wv": kv, "wo": o, "ln2": ln, **mlp}
    decoder = {"ln1": ln, "wq": q, "wk": kv, "wv": kv, "wo": o, "lnx": ln, "xwq": q,
               "xwk": kv, "xwv": kv, "xwo": o, "ln2": ln, **mlp}
    return {"embed": ("vocab", "embed"), "enc_pos": (None, "embed"),
            "dec_pos": (None, "embed"), "encoder": encoder, "enc_final_norm": (None,),
            "decoder": decoder, "final_norm": (None,), "lm_head": ("vocab", "embed")}


def init(cfg: ModelConfig, generator: torch.Generator,
         device: torch.device) -> cm.Params:
    return cm.init_params(param_specs(cfg), generator,
                          cm.dtype_of(cfg.param_dtype), device)


def _mlp(h: torch.Tensor, w_in: torch.Tensor, w_out: torch.Tensor) -> torch.Tensor:
    return F.gelu(h @ w_in, approximate="tanh") @ w_out


def _enc_layer(cfg: ModelConfig, x: torch.Tensor, lp: cm.Params) -> torch.Tensor:
    h = cm.rms_norm(x, lp["ln1"], cfg.norm_eps)
    q, k, v = (cm.project(h, lp[w]) for w in ("wq", "wk", "wv"))
    o = cm.attention(q, k, v, causal=False)
    x = cm.shard_batch(x + cm.project_out(o, lp["wo"]))
    h = cm.rms_norm(x, lp["ln2"], cfg.norm_eps)
    return cm.shard_batch(x + _mlp(h, lp["mlp_in"], lp["mlp_out"]))


def encode(cfg: ModelConfig, params: cm.Params, audio_embeds: torch.Tensor,
           remat: bool = False) -> torch.Tensor:
    """audio_embeds: (B, enc_len, D) stub frontend output -> encoder states."""
    x = audio_embeds.to(cm.dtype_of(cfg.compute_dtype))
    x = x + params["enc_pos"][None, : x.shape[1]].to(x.dtype)
    body = functools.partial(_enc_layer, cfg)
    if remat:
        body = cm.remat_wrap(body, cfg.remat_policy)
    for lp in cm.layers(params["encoder"]):
        x = body(x, lp)
    return cm.rms_norm(x, params["enc_final_norm"], cfg.norm_eps)


def _dec_layer(cfg: ModelConfig, x: torch.Tensor, lp: cm.Params, enc: torch.Tensor,
               chunk_q: int) -> torch.Tensor:
    """One decoder layer over the whole sequence (the reference's
    ``self_kv is None`` branch): causal self-attention, cross-attention
    over the encoder states, MLP."""
    h = cm.rms_norm(x, lp["ln1"], cfg.norm_eps)
    q, k, v = (cm.project(h, lp[w]) for w in ("wq", "wk", "wv"))
    o = cm.attention(q, k, v, causal=True, chunk_q=chunk_q)
    x = cm.shard_batch(x + cm.project_out(o, lp["wo"]))
    h = cm.rms_norm(x, lp["lnx"], cfg.norm_eps)
    q = cm.project(h, lp["xwq"])
    xk, xv = cm.project(enc, lp["xwk"]), cm.project(enc, lp["xwv"])
    o = cm.attention(q, xk, xv, causal=False)
    x = cm.shard_batch(x + cm.project_out(o, lp["xwo"]))
    h = cm.rms_norm(x, lp["ln2"], cfg.norm_eps)
    return cm.shard_batch(x + _mlp(h, lp["mlp_in"], lp["mlp_out"]))


def forward(cfg: ModelConfig, params: cm.Params, tokens: torch.Tensor,
            audio_embeds: torch.Tensor, remat: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens (B, S) and audio_embeds (B, enc_len, D) -> logits (B, S, V)
    and a zero auxiliary loss, as the reference returns them.  The logits
    are a product in the compute dtype, cast to the logits dtype after."""
    enc = encode(cfg, params, audio_embeds, remat=remat)
    S = tokens.shape[1]
    x = cm.embed(params["embed"], tokens, cm.dtype_of(cfg.compute_dtype))
    x = x + params["dec_pos"][None, :S].to(x.dtype)
    chunk_q = 1024 if S >= 8192 else 0
    body = functools.partial(_dec_layer, cfg, enc=enc, chunk_q=chunk_q)
    if remat:
        body = cm.remat_wrap(body, cfg.remat_policy)
    for lp in cm.layers(params["decoder"]):
        x = body(x, lp)
    x = cm.rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = (x @ params["lm_head"].T).to(cm.logits_dtype(cfg))
    return logits, torch.zeros((), dtype=torch.float32, device=logits.device)


def init_decode_cache(cfg: ModelConfig, batch: int, max_len: int,
                      device: torch.device) -> Dict[str, torch.Tensor]:
    """Zeros in ``param_dtype``: ``k``, ``v`` (L, B, max_len, Hkv, dh) for
    the decoder's self-attention and ``xk``, ``xv`` (L, B, encoder_len,
    Hkv, dh) for its cross-attention."""
    dt = cm.dtype_of(cfg.param_dtype)
    Ld, Hkv, dh = cfg.n_layers, cfg.n_kv_heads, cfg.dh
    self_kv = (Ld, batch, max_len, Hkv, dh)
    cross_kv = (Ld, batch, cfg.encoder_len, Hkv, dh)
    return {name: torch.zeros(shape, dtype=dt, device=device)
            for name, shape in (("k", self_kv), ("v", self_kv),
                                ("xk", cross_kv), ("xv", cross_kv))}


def precompute_cross_kv(cfg: ModelConfig, params: cm.Params,
                        enc: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The cross-attention keys and values of every decoder layer over the
    encoder states ``enc`` (B, S, D): two (L, B, S, Hkv, dh) tensors, each
    layer's the product the forward's cross-attention computes."""
    return tuple(torch.stack([cm.project(enc, w) for w in params["decoder"][name]])
                 for name in ("xwk", "xwv"))


def cache_axes(cfg: ModelConfig, shape_name: str = "") -> Dict[str, Tuple]:
    """Logical axes of each cache entry, the reference's tuples."""
    kv = ("layers", "batch", None, "kv", None)
    return {"k": kv, "v": kv, "xk": kv, "xv": kv}


def decode_step(cfg: ModelConfig, params: cm.Params, cache: Dict[str, torch.Tensor],
                token: torch.Tensor, pos: Union[torch.Tensor, int]
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One decoder token a sequence: ``token`` (B, 1) at position ``pos``
    (a Python int or a 0-d integer tensor on the parameters' device) ->
    the logits (B, V) in float32 and the cache.  Each layer's new key and
    value row is written into ``cache["k"]``, ``cache["v"]`` at ``pos`` in
    place (``index_copy_``), and the same dict is returned; attention
    reads positions ``<= pos``.  A device ``pos`` is never read on the
    host, so a step makes no host sync."""
    at = cm.position(pos, token.device)
    kv_len = pos + 1
    x = cm.embed(params["embed"], token, cm.dtype_of(cfg.compute_dtype))
    x = x + params["dec_pos"].index_select(0, at)[None].to(x.dtype)
    for i, lp in enumerate(cm.layers(params["decoder"])):
        k_l, v_l = cache["k"][i], cache["v"][i]
        h = cm.rms_norm(x, lp["ln1"], cfg.norm_eps)
        q, k, v = (cm.project(h, lp[w]) for w in ("wq", "wk", "wv"))
        k_l.index_copy_(1, at, k.to(k_l.dtype))
        v_l.index_copy_(1, at, v.to(v_l.dtype))
        o = cm.attention(q, k_l, v_l, causal=False, q_offset=pos, kv_len=kv_len)
        x = cm.shard_batch(x + cm.project_out(o, lp["wo"]))
        h = cm.rms_norm(x, lp["lnx"], cfg.norm_eps)
        q = cm.project(h, lp["xwq"])
        o = cm.attention(q, cache["xk"][i], cache["xv"][i], causal=False)
        x = cm.shard_batch(x + cm.project_out(o, lp["xwo"]))
        h = cm.rms_norm(x, lp["ln2"], cfg.norm_eps)
        x = cm.shard_batch(x + _mlp(h, lp["mlp_in"], lp["mlp_out"]))
    x = cm.rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = (x @ params["lm_head"].T).to(torch.float32)
    return logits[:, 0], cache


def lm_loss(cfg: ModelConfig, params: cm.Params, batch: Dict[str, Any],
            remat: bool = True) -> torch.Tensor:
    """Mean next-token cross-entropy of the decoder's logits (float32)."""
    logits, _ = forward(cfg, params, batch["tokens"], batch["audio_embeds"], remat=remat)
    return cm.next_token_ce(cfg, logits, batch["labels"])
