"""Layer profiling: per-layer forward/backward time, weight and activation sizes.

The paper profiles wall-clock per layer on the target GPU (appendix Alg. 3,
``profile(θ)``). This module gives the planner an *analytic* profile: per-layer
FLOPs and bytes are derived from the architecture config and converted to
time with the roofline of one NVIDIA H100 SXM
(t = max(flops / (util · peak), bytes / hbm_bw)). Measured profiles are a
later slice of the port; a caller may pass its own ``ModelProfile``.
"""

from __future__ import annotations

import dataclasses
from typing import List

from repro_torch.models.config import ModelConfig

# NVIDIA H100 SXM data-sheet figures (dense, no sparsity, at the 700 W limit).
H100_SXM_PEAK_FLOPS_BF16 = 989e12  # FLOP/s
H100_SXM_HBM_BW = 3.35e12  # B/s
# Planning assumption, not a measurement: the fraction of the bf16 peak a
# dense matrix product reaches.
DEFAULT_UTILIZATION = 0.55


@dataclasses.dataclass(frozen=True)
class LayerProfile:
    """One model layer (block) as seen by the planner."""

    t_fwd: float  # seconds, forward
    t_bwd: float  # seconds, backward
    w_bytes: int  # parameter bytes |ŵ_i|
    a_bytes: int  # boundary activation bytes |â_i| (stage input/output)
    a_internal_bytes: int  # intra-layer activations recomputable under T1


@dataclasses.dataclass(frozen=True)
class ModelProfile:
    layers: List[LayerProfile]
    embed_bytes: int  # embedding + head parameter bytes (stage 0 / last stage)
    batch: int
    seq: int
    # where the numbers came from ("analytic" here; a caller's own profile
    # may say otherwise)
    provenance: str = "analytic"

    @property
    def num_layers(self) -> int:
        return len(self.layers)

    def total_w(self) -> int:
        return sum(ly.w_bytes for ly in self.layers)


def _block_flops_per_token(cfg: ModelConfig, seq: int) -> float:
    """Forward FLOPs per token for one block (matmul-dominated, 2·m·n·k)."""
    d, ff = cfg.d_model, cfg.d_ff
    hd = cfg.resolved_head_dim
    f = 0.0
    if cfg.uses_attention:
        q, kv = cfg.num_heads * hd, cfg.num_kv_heads * hd
        f += 2.0 * d * (q + 2 * kv + q)  # qkv + out projections (wq,wk,wv,wo)
        # score/value matmuls against effective context length
        kinds = cfg.layer_kinds()
        w0 = cfg.window_for_kind(kinds[0])
        ctx = min(seq, w0) if w0 is not None else seq
        f += 2.0 * 2.0 * cfg.num_heads * hd * (ctx / 2.0)  # causal: avg ctx/2
    if cfg.uses_ssm:
        di, n, nh, ph = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_headdim
        f += 2.0 * d * (2 * di + 2 * n + nh)  # z/x/B/C/dt projections
        f += 2.0 * di * d  # out projection
        # SSD: intra-chunk (Q per token) + state update (n per channel)
        Q = cfg.ssm_chunk
        f += 2.0 * nh * ph * Q  # C·B^T ⊙ L intra-chunk (amortized per token)
        f += 4.0 * di * n  # state update + output contraction
    if ff > 0:
        active = cfg.experts_per_token if cfg.uses_moe else 1
        f += 2.0 * 3.0 * d * ff * active
        if cfg.uses_moe:
            f += 2.0 * d * cfg.num_experts  # router
    return f


def _block_w_bytes(cfg: ModelConfig, dtype_bytes: int = 4) -> int:
    total = cfg.param_count()
    embed = cfg.vocab_size * cfg.d_model * (1 if cfg.tie_embeddings else 2)
    per_layer = (total - embed - cfg.d_model) // cfg.num_layers
    return per_layer * dtype_bytes


def _block_a_bytes(cfg: ModelConfig, batch: int, seq: int, dtype_bytes: int = 2) -> int:
    """Boundary activation bytes per microbatch: (b, s, d)."""
    return batch * seq * cfg.d_model * dtype_bytes


def _block_a_internal_bytes(cfg: ModelConfig, batch: int, seq: int, dtype_bytes: int = 2) -> int:
    """Intra-block activations that T1 recomputation avoids storing."""
    d, ff = cfg.d_model, cfg.d_ff
    hd = cfg.resolved_head_dim
    per_token = 0
    if cfg.uses_attention:
        per_token += cfg.num_heads * hd + 2 * cfg.num_kv_heads * hd  # q, k, v
        per_token += cfg.num_heads * hd  # attn out pre-proj
    if cfg.uses_ssm:
        per_token += 2 * cfg.d_inner + 2 * cfg.ssm_state + cfg.ssm_heads
        per_token += cfg.d_inner
    if ff > 0:
        active = cfg.experts_per_token if cfg.uses_moe else 1
        per_token += 2 * ff * active + d
    return batch * seq * per_token * dtype_bytes


def analytic_profile(
    cfg: ModelConfig,
    batch: int,
    seq: int,
    utilization: float = DEFAULT_UTILIZATION,
    param_dtype_bytes: int = 4,
    act_dtype_bytes: int = 2,
) -> ModelProfile:
    """Roofline-derived per-layer profile for a microbatch of (batch, seq)."""
    tokens = batch * seq
    f_fwd = _block_flops_per_token(cfg, seq) * tokens
    w_b = _block_w_bytes(cfg, param_dtype_bytes)
    a_b = _block_a_bytes(cfg, batch, seq, act_dtype_bytes)
    a_int = _block_a_internal_bytes(cfg, batch, seq, act_dtype_bytes)

    def t_of(flops, bytes_moved):
        return max(
            flops / (utilization * H100_SXM_PEAK_FLOPS_BF16), bytes_moved / H100_SXM_HBM_BW
        )

    t_f = t_of(f_fwd, w_b + a_b + a_int)
    t_b = t_of(2.0 * f_fwd, 2 * (w_b + a_b + a_int))
    layers = [LayerProfile(t_f, t_b, w_b, a_b, a_int) for _ in range(cfg.num_layers)]
    embed_bytes = cfg.vocab_size * cfg.d_model * param_dtype_bytes
    if not cfg.tie_embeddings:
        embed_bytes *= 2
    return ModelProfile(layers=layers, embed_bytes=embed_bytes, batch=batch, seq=seq)
