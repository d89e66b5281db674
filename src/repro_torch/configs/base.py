"""Model configuration dataclass (the port's copy of
``repro.configs.base.ModelConfig``, same fields and defaults).

Each configuration module exports ``CONFIG``, the exact full-size
configuration; :meth:`ModelConfig.reduced` returns the smoke-test variant
(2 layers, d_model <= 256, float32) that the CPU tests run.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


@dataclass(frozen=True)
class ModelConfig:
    # identity ------------------------------------------------------------
    name: str = "model"
    family: str = "dense"  # dense | moe | ssm | hybrid | encdec | vlm | resnet
    source: str = ""       # citation ([arXiv:...] / [hf:...])

    # transformer backbone --------------------------------------------------
    n_layers: int = 2
    d_model: int = 256
    n_heads: int = 4
    n_kv_heads: int = 4
    head_dim: int = 0          # 0 -> d_model // n_heads
    d_ff: int = 1024
    vocab_size: int = 1000
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-6
    tie_embeddings: bool = False

    # gemma2-style options --------------------------------------------------
    attn_softcap: float = 0.0      # 0 disables
    final_softcap: float = 0.0
    sliding_window: int = 0        # 0 disables; used by "local" layers
    local_global_alternating: bool = False  # [local, global] layer pairs

    # MoE -------------------------------------------------------------------
    n_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0              # expert hidden size (0 -> d_ff)
    n_shared_experts: int = 0      # always-on experts (Kimi K2 style)
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01
    moe_every: int = 1             # MoE every k-th layer (Jamba: 2)

    # SSM (Mamba2 / SSD) ------------------------------------------------------
    ssm_state: int = 0             # d_state; 0 disables SSM
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_conv_kernel: int = 4
    ssm_chunk: int = 256
    attn_layer_period: int = 0     # hybrid: 1 attention layer every k (Jamba: 8)

    # encoder-decoder (Whisper) ----------------------------------------------
    n_encoder_layers: int = 0
    encoder_len: int = 0           # audio frame-embedding length (stub frontend)

    # VLM (InternVL) ----------------------------------------------------------
    n_patches: int = 0             # patch-embedding prefix length (stub frontend)

    # numerics ---------------------------------------------------------------
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    fp32_logits: bool = True       # cast LM logits to f32 (baseline)
    remat_policy: str = "nothing_saveable"
    ce_impl: str = "logp"
    attn_f32: bool = True          # f32 score/softmax chain

    # ------------------------------------------------------------------
    @property
    def dh(self) -> int:
        return self.head_dim or (self.d_model // max(self.n_heads, 1))

    @property
    def padded_vocab(self) -> int:
        """Vocab padded to a multiple of 256 (the reference's sharding
        rule; the port keeps it so both packages hold the same shapes)."""
        return _round_up(self.vocab_size, 256)

    @property
    def d_inner(self) -> int:
        """The Mamba2 mixer's inner width."""
        return self.ssm_expand * self.d_model

    @property
    def n_ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def expert_d_ff(self) -> int:
        """An expert's hidden width (``moe_d_ff``, else ``d_ff``)."""
        return self.moe_d_ff or self.d_ff

    def reduced(self) -> "ModelConfig":
        """Smoke-test variant: 2 layers (blocks), d_model<=256, <=4 experts."""
        changes = dict(
            name=self.name + "-smoke",
            d_model=min(self.d_model, 256),
            n_heads=4,
            n_kv_heads=2 if self.n_kv_heads < self.n_heads else 4,
            head_dim=64,
            d_ff=min(self.d_ff, 512) or 0,
            vocab_size=min(self.vocab_size, 512),
            param_dtype="float32",
            compute_dtype="float32",
        )
        if self.family == "hybrid":
            changes["n_layers"] = max(self.attn_layer_period, 2)  # one block
            changes["attn_layer_period"] = max(self.attn_layer_period, 2)
        else:
            changes["n_layers"] = 2
        if self.n_experts:
            changes["n_experts"] = min(self.n_experts, 4)
            changes["top_k"] = min(self.top_k, 2)
            changes["moe_d_ff"] = min(self.expert_d_ff, 256)
            changes["n_shared_experts"] = min(self.n_shared_experts, 1)
        if self.ssm_state:
            changes["ssm_state"] = min(self.ssm_state, 64)
            changes["ssm_head_dim"] = 32
            changes["ssm_chunk"] = 32
        if self.n_encoder_layers:
            changes["n_encoder_layers"] = 2
            changes["encoder_len"] = 64
        if self.n_patches:
            changes["n_patches"] = 16
        if self.sliding_window:
            changes["sliding_window"] = 64
        return dataclasses.replace(self, **changes)
