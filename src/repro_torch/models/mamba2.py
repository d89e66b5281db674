"""Mamba2 (SSD, state-space duality, arXiv:2405.21060), the port of
``repro.models.mamba2``: the mixer and the attention-free mamba2 LM.

The prefill runs the chunked SSD dual form: within a chunk of Q
positions an attention-like (Q x Q) product, between chunks a recurrence
over the S/Q chunk states, here a loop over the chunks on the device (the
reference's log-depth associative scan computes the same sums in another
order).  Decode keeps the recurrent state (B, nh, N, hd) in float32 and a
ring of the last k - 1 conv inputs in ``param_dtype``.  The mixer is
reused by the Jamba hybrid (``models/jamba.py``).

``lm_loss`` is the next-token cross-entropy; ``forward(..., remat=True)``
checkpoints each layer under ``cfg.remat_policy``.
"""
from __future__ import annotations

import functools
from typing import Any, Dict, Optional, Tuple, Union

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models import common as cm

# ---------------------------------------------------------------------------
# the mixer
# ---------------------------------------------------------------------------


def mixer_specs(cfg: ModelConfig, L: int) -> cm.Specs:
    """Stacked (L, ...) mixer parameters, in the reference's order."""
    D, di, N = cfg.d_model, cfg.d_inner, cfg.ssm_state
    nh, ck = cfg.n_ssm_heads, cfg.ssm_conv_kernel
    conv_dim = di + 2 * N
    s = cm.spec
    return {
        "in_z": s((L, D, di)),
        "in_x": s((L, D, di)),
        "in_B": s((L, D, N)),
        "in_C": s((L, D, N)),
        "in_dt": s((L, D, nh)),
        "conv_w": s((L, ck, conv_dim)),
        "conv_b": s((L, conv_dim), init="zeros"),
        "dt_bias": s((L, nh), init="zeros"),
        "A_log": s((L, nh), scale=0.5),
        "D_skip": s((L, nh), init="ones"),
        "norm": s((L, di), init="zeros"),
        "out": s((L, di, D)),
    }


def mixer_axes() -> Dict[str, Tuple]:
    """The logical axis names of :func:`mixer_specs`' parameters."""
    return {"in_z": ("layers", "embed", "ffn"), "in_x": ("layers", "embed", "ffn"),
            "in_B": ("layers", "embed", None), "in_C": ("layers", "embed", None),
            "in_dt": ("layers", "embed", "heads"), "conv_w": ("layers", None, "ffn"),
            "conv_b": ("layers", "ffn"), "dt_bias": ("layers", "heads"),
            "A_log": ("layers", "heads"), "D_skip": ("layers", "heads"),
            "norm": ("layers", "ffn"), "out": ("layers", "ffn", "embed")}


def _conv_causal(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv along the sequence, x (B, S, Cd), w (k, Cd):
    k unrolled taps in x's type, as the reference computes it."""
    k, S = w.shape[0], x.shape[1]
    pad = F.pad(x, (0, 0, k - 1, 0))
    out = torch.zeros_like(x)
    for i in range(k):
        out = out + pad[:, i:i + S] * w[i]
    return out + b


def _split_proj(lp: cm.Params, u: torch.Tensor):
    return tuple(u @ lp[n] for n in ("in_z", "in_x", "in_B", "in_C", "in_dt"))


def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, Bm: torch.Tensor,
                Cm: torch.Tensor, chunk: int, h0: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The chunked SSD scan: x (B, S, nh, hd), dt (B, S, nh) after the
    softplus, A (nh,) negative, Bm and Cm (B, S, N), an optional carried-in
    state h0 (B, nh, N, hd) -> (y (B, S, nh, hd) in x's type, the final
    state (B, nh, N, hd) float32).  Everything inside runs in float32.

    The three-operand contractions of the reference are ordered so that no
    (B, nc, Q, nh, N, hd) tensor is built: the chunk states as
    ``B^T (x dt decay)`` and the inter-chunk output as ``C h`` times the
    decay.  The exponent of the intra-chunk decay is masked to -inf above
    the diagonal before ``exp`` (there it is positive and may overflow;
    ``inf * 0`` after masking would be NaN)."""
    B_, S, nh, hd = x.shape
    N = Bm.shape[-1]
    if S % chunk:
        raise ValueError(f"sequence {S} is not a multiple of the chunk {chunk}")
    nc = S // chunk
    xc = x.reshape(B_, nc, chunk, nh, hd).float()
    dtc = dt.reshape(B_, nc, chunk, nh).float()
    Bc = Bm.reshape(B_, nc, chunk, N).float()
    Cc = Cm.reshape(B_, nc, chunk, N).float()

    a_cs = torch.cumsum(dtc * A, dim=2)               # (B, nc, Q, nh), inclusive
    a_tot = a_cs[:, :, -1]                            # (B, nc, nh)
    x_dt = xc * dtc[..., None]                        # (B, nc, Q, nh, hd)
    a_h = a_cs.transpose(2, 3)                        # (B, nc, nh, Q)

    # intra-chunk (dual, attention-like) term, heads before positions
    cb = Cc @ Bc.transpose(-1, -2)                    # (B, nc, i, j)
    causal = torch.ones(chunk, chunk, dtype=torch.bool, device=x.device).tril()
    att = (a_h[..., :, None] - a_h[..., None, :]).masked_fill_(~causal, float("-inf"))
    # exp_ keeps its result for the backward: the product is a new tensor
    att = att.exp_() * cb[:, :, None]                 # (B, nc, nh, i, j)
    xh = x_dt.transpose(2, 3)                         # (B, nc, nh, Q, hd)
    y = att @ xh                                      # (B, nc, nh, i, hd)
    del att

    # each chunk's state: sum_j B[j, n] decay[j, h] x_dt[j, h, p]
    sdecay = torch.exp(a_tot[:, :, None, :] - a_cs)  # (B, nc, Q, nh)
    w = (x_dt * sdecay[..., None]).reshape(B_, nc, chunk, nh * hd)
    states = (Bc.transpose(-1, -2) @ w).reshape(B_, nc, N, nh, hd).transpose(2, 3)

    # the recurrence between chunks, h_c = exp(a_tot_c) h_{c-1} + s_c; the
    # state before each chunk feeds its inter-chunk output
    decay = torch.exp(a_tot)[..., None, None]        # (B, nc, nh, 1, 1)
    h = (torch.zeros((B_, nh, N, hd), dtype=torch.float32, device=x.device)
         if h0 is None else h0.float())
    h_in = []
    for c in range(nc):
        h_in.append(h)
        h = decay[:, c] * h + states[:, c]
    h_in = torch.stack(h_in, dim=1)                   # (B, nc, nh, N, hd)
    y = y + (Cc[:, :, None] @ h_in) * torch.exp(a_h)[..., None]
    return y.transpose(2, 3).reshape(B_, S, nh, hd).to(x.dtype), h


def _core(cfg: ModelConfig, x, Bm, Cm, dt, conv_w, conv_b, dt_bias, A_log, D_skip):
    """The mixer between its projections: the causal conv and SiLU in the
    compute type, dt = softplus(dt + dt_bias) in float32, A = -exp(A_log),
    the SSD scan and the D skip -> (B, S, d_inner)."""
    B_, S = x.shape[:2]
    di, N, nh, hd = cfg.d_inner, cfg.ssm_state, cfg.n_ssm_heads, cfg.ssm_head_dim
    xbc = F.silu(_conv_causal(torch.cat([x, Bm, Cm], dim=-1), conv_w, conv_b))
    x, Bm, Cm = xbc[..., :di], xbc[..., di:di + N], xbc[..., di + N:]
    dt = F.softplus(dt.float() + dt_bias.float())
    A = -torch.exp(A_log.float())
    xs = x.reshape(B_, S, nh, hd)
    y, _ = ssd_chunked(xs, dt, A, Bm, Cm, chunk=min(cfg.ssm_chunk, S))
    return (y + xs * D_skip[None, None, :, None].to(y.dtype)).reshape(B_, S, di)


def mixer_forward(cfg: ModelConfig, lp: cm.Params, u: torch.Tensor) -> torch.Tensor:
    """The full-sequence mixer, u (B, S, D) -> (B, S, D): projections,
    the core (:func:`_core`; on DTensors each rank's rows of the batch,
    ``common.on_batch_rows``), the gated RMS norm and the out
    projection."""
    z, x, Bm, Cm, dt = _split_proj(lp, u)
    rows, shared = (x, Bm, Cm, dt), tuple(lp[n] for n in ("conv_w", "conv_b", "dt_bias",
                                                          "A_log", "D_skip"))
    core = functools.partial(_core, cfg)
    y = cm.on_batch_rows(core, rows, shared) if cm.is_dtensor(u) else core(*rows, *shared)
    y = cm.rms_norm(y * F.silu(z), lp["norm"], cfg.norm_eps)
    return y @ lp["out"]


def mixer_cache(cfg: ModelConfig, L: int, batch: int,
                device: torch.device) -> Dict[str, torch.Tensor]:
    """Zeros: ``ssm`` (L, B, nh, N, hd) float32 and ``conv`` (L, B, k - 1,
    conv_dim) in ``param_dtype``."""
    di, N = cfg.d_inner, cfg.ssm_state
    nh, hd, ck = cfg.n_ssm_heads, cfg.ssm_head_dim, cfg.ssm_conv_kernel
    return {
        "ssm": torch.zeros((L, batch, nh, N, hd), dtype=torch.float32, device=device),
        "conv": torch.zeros((L, batch, ck - 1, di + 2 * N),
                            dtype=cm.dtype_of(cfg.param_dtype), device=device),
    }


def mixer_decode(cfg: ModelConfig, lp: cm.Params, ssm_state: torch.Tensor,
                 conv_state: torch.Tensor, u: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One token, u (B, 1, D), against the state (B, nh, N, hd) and the
    conv ring (B, k - 1, conv_dim) -> (out (B, 1, D), the new state, the
    new ring).  The conv and the recurrence run in float32; the ring keeps
    the raw projections in its own type."""
    B_ = u.shape[0]
    di, N, nh, hd = cfg.d_inner, cfg.ssm_state, cfg.n_ssm_heads, cfg.ssm_head_dim
    z, x, Bm, Cm, dt = _split_proj(lp, u)
    xbc = torch.cat([x, Bm, Cm], dim=-1)[:, 0]                # (B, conv_dim)
    window = torch.cat([conv_state, xbc[:, None]], dim=1)     # (B, k, conv_dim)
    conv = (window.float() * lp["conv_w"].float()).sum(1) + lp["conv_b"]
    xbc = F.silu(conv)
    x, Bv, Cv = xbc[..., :di], xbc[..., di:di + N], xbc[..., di + N:]
    dt = F.softplus(dt[:, 0].float() + lp["dt_bias"].float())  # (B, nh)
    A = -torch.exp(lp["A_log"].float())
    xh = x.reshape(B_, nh, hd).float()
    upd = Bv.float()[:, None, :, None] * (xh * dt[..., None])[:, :, None, :]
    ssm_new = ssm_state * torch.exp(dt * A)[..., None, None] + upd   # (B, nh, N, hd)
    y = (Cv.float()[:, None, None, :] @ ssm_new)[:, :, 0]           # (B, nh, hd)
    y = y + xh * lp["D_skip"][None, :, None].float()
    y = y.reshape(B_, 1, di).to(u.dtype)
    y = cm.rms_norm(y * F.silu(z), lp["norm"], cfg.norm_eps)
    return y @ lp["out"], ssm_new, window[:, 1:].to(conv_state.dtype)


# ---------------------------------------------------------------------------
# the mamba2 LM
# ---------------------------------------------------------------------------


def param_specs(cfg: ModelConfig) -> cm.Specs:
    D, L, V = cfg.d_model, cfg.n_layers, cfg.padded_vocab
    s = cm.spec
    return {
        "embed": s((V, D), scale=1.0),
        "layers": {"ln": s((L, D), init="zeros"), **mixer_specs(cfg, L)},
        "final_norm": s((D,), init="zeros"),
        "lm_head": s((V, D)),
    }


def param_axes(cfg: ModelConfig) -> Dict[str, Any]:
    """Every parameter's logical axis names, the tree the reference's
    ``init`` returns beside its parameters (the structure of
    :func:`param_specs`)."""
    return {"embed": ("vocab", "embed"), "layers": {"ln": ("layers", None), **mixer_axes()},
            "final_norm": (None,), "lm_head": ("vocab", "embed")}


def init(cfg: ModelConfig, generator: torch.Generator, device: torch.device) -> cm.Params:
    return cm.init_params(param_specs(cfg), generator, cm.dtype_of(cfg.param_dtype), device)


def _mixer(lp: cm.Params) -> cm.Params:
    return {n: w for n, w in lp.items() if n != "ln"}


def _layer(cfg: ModelConfig, x: torch.Tensor, lp: cm.Params) -> torch.Tensor:
    return cm.shard_batch(x + mixer_forward(cfg, _mixer(lp),
                                            cm.rms_norm(x, lp["ln"], cfg.norm_eps)))


def forward(cfg: ModelConfig, params: cm.Params, tokens: torch.Tensor,
            remat: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens (B, S) -> logits (B, S, V) in the logits dtype and a zero
    auxiliary loss."""
    x = cm.embed(params["embed"], tokens, cm.dtype_of(cfg.compute_dtype))
    body = functools.partial(_layer, cfg)
    if remat:
        body = cm.remat_wrap(body, cfg.remat_policy)
    for lp in cm.layers(params["layers"]):
        x = body(x, lp)
    x = cm.rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = (x @ params["lm_head"].T).to(cm.logits_dtype(cfg))
    return logits, torch.zeros((), dtype=torch.float32, device=logits.device)


def init_decode_cache(cfg: ModelConfig, batch: int, max_len: int,
                      device: torch.device) -> Dict[str, torch.Tensor]:
    """The constant-size state of every layer (``max_len`` unused)."""
    del max_len
    return mixer_cache(cfg, cfg.n_layers, batch, device)


def cache_axes(cfg: ModelConfig, shape_name: str = "") -> Dict[str, Tuple]:
    return {
        "ssm": ("layers", "batch", "heads", None, None),
        "conv": ("layers", "batch", None, "ffn"),
    }


def decode_step(cfg: ModelConfig, params: cm.Params, cache: Dict[str, torch.Tensor],
                token: torch.Tensor, pos: Union[torch.Tensor, int]
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One token a sequence (``pos`` unused: the state is the history) ->
    the logits (B, V) float32 and the cache, updated in place."""
    del pos
    x = cm.embed(params["embed"], token, cm.dtype_of(cfg.compute_dtype))
    for i, lp in enumerate(cm.layers(params["layers"])):
        h = cm.rms_norm(x, lp["ln"], cfg.norm_eps)
        out, ssm, conv = mixer_decode(cfg, _mixer(lp), cache["ssm"][i], cache["conv"][i], h)
        cache["ssm"][i].copy_(ssm)
        cache["conv"][i].copy_(conv)
        x = cm.shard_batch(x + out)
    x = cm.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return (x @ params["lm_head"].T).to(torch.float32)[:, 0], cache


def lm_loss(cfg: ModelConfig, params: cm.Params, batch: Dict[str, Any],
            remat: bool = True) -> torch.Tensor:
    """Mean next-token cross-entropy (float32)."""
    logits, _ = forward(cfg, params, batch["tokens"], remat=remat)
    return cm.next_token_ce(cfg, logits, batch["labels"])
