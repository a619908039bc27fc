"""Model configuration for the repro_torch model zoo (copy of
``repro.models.config`` with a torch dtype in place of the jnp one).

One unified dataclass covers all six architecture families assigned to this
paper (dense / moe / ssm / hybrid / vlm / audio).  Family-specific fields are
zero/empty when unused.  Every config in ``repro_torch.configs`` instantiates this.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | vlm | audio

    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int

    # attention details
    head_dim: int = 0              # 0 -> d_model // n_heads
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-5
    sliding_window: int = 0        # 0 = full attention everywhere
    global_every: int = 1          # every k-th layer (1-indexed, i.e. layers
                                   # with (i+1) % global_every == 0) is global;
                                   # 1 = all layers global. Only meaningful if
                                   # sliding_window > 0.
    attn_logit_softcap: float = 0.0
    final_logit_softcap: float = 0.0

    # mixture of experts
    moe_experts: int = 0
    moe_top_k: int = 2
    moe_impl: str = "dense"        # dense (scan over experts) | capacity

    # xLSTM (family == "ssm")
    slstm_every: int = 0           # every k-th block is sLSTM; 0 = all mLSTM
    proj_factor: float = 2.0       # mLSTM up-projection factor
    conv_kernel: int = 4           # causal depthwise conv width in mLSTM block

    # Hymba-style hybrid (family == "hybrid")
    ssm_state: int = 0             # mamba state size per head-channel

    # MusicGen-style audio LM (family == "audio")
    n_codebooks: int = 0

    # VLM backbone (family == "vlm")
    vision_tokens: int = 0         # stub patch embeddings prepended

    tie_embeddings: bool = True
    dtype: str = "bfloat16"

    # ---- derived ------------------------------------------------------
    @property
    def hd(self) -> int:
        return self.head_dim if self.head_dim else self.d_model // self.n_heads

    @property
    def q_rep(self) -> int:
        return self.n_heads // self.n_kv_heads

    @property
    def tdtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    def layer_windows(self) -> Tuple[int, ...]:
        """Per-layer attention window (0 = full/global attention)."""
        if self.sliding_window <= 0:
            return tuple(0 for _ in range(self.n_layers))
        out = []
        for i in range(self.n_layers):
            is_global = self.global_every <= 1 or ((i + 1) % self.global_every == 0)
            out.append(0 if is_global else self.sliding_window)
        # if global_every==0 -> all local
        if self.global_every == 0:
            out = [self.sliding_window] * self.n_layers
        return tuple(out)

    def layer_is_slstm(self) -> Tuple[bool, ...]:
        if self.family != "ssm" or self.slstm_every <= 0:
            return tuple(False for _ in range(self.n_layers))
        return tuple(((i + 1) % self.slstm_every == 0) for i in range(self.n_layers))

    def n_params(self) -> int:
        """Approximate parameter count (used for roofline MODEL_FLOPS)."""
        D, F, V, L = self.d_model, self.d_ff, self.vocab_size, self.n_layers
        hd, H, KV = self.hd, self.n_heads, self.n_kv_heads
        emb = V * D
        if self.n_codebooks:
            emb = self.n_codebooks * V * D
        per_layer = 0
        if self.family == "ssm":
            # mLSTM block: up-proj 2*pf*D, qkv from pf*D, down-proj
            Dp = int(self.proj_factor * D)
            per_layer = D * 2 * Dp + 3 * Dp * Dp // max(1, self.q_rep) + Dp * D + 4 * Dp
        else:
            per_layer += D * H * hd + 2 * D * KV * hd + H * hd * D  # attn
            if self.family == "hybrid":
                per_layer += D * H * hd * 2 + H * hd * D  # ssm in/out
            if self.moe_experts:
                per_layer += D * self.moe_experts + self.moe_experts * 3 * D * F
            elif F:
                per_layer += 3 * D * F
        head = 0 if self.tie_embeddings else V * D * max(1, self.n_codebooks)
        return emb + L * per_layer + head

    def n_active_params(self) -> int:
        """Active params per token (MoE counts top_k experts only)."""
        if not self.moe_experts:
            return self.n_params()
        D, F, L = self.d_model, self.d_ff, self.n_layers
        inactive = L * (self.moe_experts - self.moe_top_k) * 3 * D * F
        return self.n_params() - inactive
