"""Model configuration dataclass and the assigned input shapes (the
port's copy of ``repro.configs.base``: ``ModelConfig`` with the same
fields, defaults and parameter counts, ``InputShape``, ``INPUT_SHAPES``
and ``SHAPES_BY_NAME``).

Each configuration module exports ``CONFIG``, the exact full-size
configuration; :meth:`ModelConfig.reduced` returns the smoke-test variant
(2 layers, d_model <= 256, float32) that the CPU tests run.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Tuple


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

    def param_count(self) -> int:
        """Analytic parameter count (used for MODEL_FLOPS and FedAvg comm):
        the reference's formula, family by family; a family without one
        (the ResNet's) counts the embeddings alone, as there."""
        D, V = self.d_model, self.padded_vocab
        emb = V * D * (1 if self.tie_embeddings else 2)
        total = emb
        H, Hkv, dh = self.n_heads, self.n_kv_heads, self.dh
        attn = D * H * dh + 2 * D * Hkv * dh + H * dh * D
        dense_ffn = 3 * D * self.d_ff
        moe_ffn = self.n_experts * 3 * D * self.expert_d_ff + D * self.n_experts
        shared = self.n_shared_experts * 3 * D * self.expert_d_ff
        di, ns, nh = self.d_inner, self.ssm_state, self.n_ssm_heads
        ssm = D * (2 * di + 2 * ns + nh) + (di + 2 * ns) * self.ssm_conv_kernel + di * D + 2 * nh
        if self.family in ("dense", "vlm"):
            total += self.n_layers * (attn + dense_ffn)
        elif self.family == "moe":
            total += self.n_layers * (attn + moe_ffn + shared)
        elif self.family == "ssm":
            total += self.n_layers * ssm
        elif self.family == "hybrid":
            n_attn = self.n_layers // max(self.attn_layer_period, 1)
            n_moe = self.n_layers // max(self.moe_every, 1)
            total += (n_attn * attn + (self.n_layers - n_attn) * ssm + n_moe * moe_ffn
                      + (self.n_layers - n_moe) * dense_ffn)
        elif self.family == "encdec":
            enc = self.n_encoder_layers * (attn + dense_ffn)
            dec = self.n_layers * (2 * attn + dense_ffn)  # self + cross
            total += enc + dec + self.encoder_len * D  # learned enc pos
        return int(total)

    def active_param_count(self) -> int:
        """Active parameters a token (MoE: the top_k and shared experts
        only)."""
        if self.n_experts == 0:
            return self.param_count()
        n_moe = (self.n_layers // max(self.moe_every, 1) if self.family == "hybrid"
                 else self.n_layers)
        inactive = n_moe * (self.n_experts - self.top_k) * 3 * self.d_model * self.expert_d_ff
        return int(self.param_count() - inactive)

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


@dataclass(frozen=True)
class InputShape:
    """An assigned (name, seq_len, global_batch, mode) input shape."""

    name: str
    seq_len: int
    global_batch: int
    mode: str  # "train" | "prefill" | "decode"


INPUT_SHAPES: Tuple[InputShape, ...] = (
    InputShape("train_4k", 4_096, 256, "train"),
    InputShape("prefill_32k", 32_768, 32, "prefill"),
    InputShape("decode_32k", 32_768, 128, "decode"),
    InputShape("long_500k", 524_288, 1, "decode"),
)

SHAPES_BY_NAME = {s.name: s for s in INPUT_SHAPES}
