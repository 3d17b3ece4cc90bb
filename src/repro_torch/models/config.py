"""Architecture configuration shared by the whole framework."""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Static description of one architecture.

    The same dataclass describes dense, MoE, SSM, hybrid, VLM and audio
    backbones; family-specific fields are simply unused by other families.
    """

    name: str
    family: str  # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int

    # --- attention ---
    head_dim: Optional[int] = None  # default: d_model // num_heads
    qkv_bias: bool = False
    window: Optional[int] = None  # sliding-window size for *all* attn layers
    local_global_ratio: int = 0  # e.g. 5 -> 5 local : 1 global (gemma3)
    local_window: int = 1024
    rope_theta: float = 10_000.0
    mrope_sections: Optional[Tuple[int, int, int]] = None  # qwen2-vl M-RoPE

    # --- MoE ---
    num_experts: int = 0
    experts_per_token: int = 0
    moe_capacity_factor: float = 1.25

    # --- SSM (mamba2 / hymba) ---
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_headdim: int = 64
    ssm_conv: int = 4
    ssm_chunk: int = 64

    # --- embedding / IO ---
    tie_embeddings: bool = False
    embed_inputs: bool = True  # False: batch provides pre-computed embeddings
    frontend: Optional[str] = None  # 'vision' | 'audio' | None (stubbed)

    # --- numerics ---
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    kv_cache_dtype: str = "bfloat16"  # "int8": quantized KV cache (+f32 scales)
    norm_eps: float = 1e-6

    # ------------------------------------------------------------------
    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim is not None:
            return self.head_dim
        return self.d_model // self.num_heads if self.num_heads else 0

    @property
    def d_inner(self) -> int:
        """SSM inner width."""
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_headdim

    @property
    def q_per_kv(self) -> int:
        return self.num_heads // max(self.num_kv_heads, 1)

    @property
    def uses_attention(self) -> bool:
        return self.family != "ssm"

    @property
    def uses_ssm(self) -> bool:
        return self.family in ("ssm", "hybrid")

    @property
    def uses_moe(self) -> bool:
        return self.num_experts > 0

    @property
    def full_attention_only(self) -> bool:
        """True when *every* attention layer is unbounded full attention.

        Such architectures cannot run the 524k-token ``long_500k`` shape
        (quadratic/unbounded KV); see DESIGN.md §Arch-applicability.
        """
        if not self.uses_attention:
            return False
        if self.window is not None:
            return False
        if self.local_global_ratio > 0:
            return False  # mostly-windowed, global layers use sharded KV
        if self.family == "hybrid":
            return False
        return True

    def layer_kinds(self) -> Tuple[int, ...]:
        """Per-layer attention kind: 0 = full/global, 1 = local window.

        gemma3-style ``local_global_ratio = r`` yields the repeating pattern
        [local]*r + [global], aligned so the final layer is global.
        """
        if not self.uses_attention:
            return tuple(0 for _ in range(self.num_layers))
        if self.local_global_ratio <= 0:
            kind = 1 if self.window is not None else 0
            return tuple(kind for _ in range(self.num_layers))
        r = self.local_global_ratio
        return tuple(0 if (i % (r + 1)) == r else 1 for i in range(self.num_layers))

    def window_for_kind(self, kind: int) -> Optional[int]:
        if kind == 1:
            return self.local_window if self.local_global_ratio > 0 else self.window
        return self.window  # kind 0: full (None) unless global window set

    # ------------------------------------------------------------------
    def param_count(self) -> int:
        """Total parameter count (all experts counted)."""
        d, ff, V = self.d_model, self.d_ff, self.vocab_size
        hd = self.resolved_head_dim
        n = 0
        n += V * d  # embed
        if not self.tie_embeddings:
            n += d * V  # lm head
        per_layer = d  # shared pre-norm (one per block for all families)
        if self.uses_attention:
            q = self.num_heads * hd
            kv = self.num_kv_heads * hd
            per_layer += d * q + 2 * d * kv + q * d  # wq wk wv wo
            if self.qkv_bias:
                per_layer += q + 2 * kv
        if self.uses_ssm:
            di, ns, nh = self.d_inner, self.ssm_state, self.ssm_heads
            d_in_proj = 2 * di + 2 * ns + nh
            per_layer += d * d_in_proj
            per_layer += self.ssm_conv * (di + 2 * ns)  # conv kernels
            per_layer += di + 2 * ns  # conv biases
            per_layer += 3 * nh  # A_log, D, dt_bias
            per_layer += di * d  # out_proj
            per_layer += di  # gate norm
        if ff > 0:
            if self.uses_moe:
                per_layer += d * self.num_experts  # router
                per_layer += self.num_experts * 3 * d * ff
            else:
                per_layer += 3 * d * ff  # gate, up, down (SwiGLU)
            per_layer += d  # mlp norm
        n += self.num_layers * per_layer
        n += d  # final norm
        return n

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE: only routed experts)."""
        if not self.uses_moe:
            return self.param_count()
        d, ff = self.d_model, self.d_ff
        inactive = self.num_layers * (self.num_experts - self.experts_per_token) * 3 * d * ff
        return self.param_count() - inactive
