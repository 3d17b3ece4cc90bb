"""Dense decoder layers as plain functions over tensor dicts.

Counterpart of the dense subset of ``repro.models.layers``:
- activations travel in ``cfg.compute_dtype``; norms, softmax and the loss
  accumulate in float32;
- attention tensors are laid out ``(batch, seq, heads, head_dim)``, the
  JAX package's layout, so the two compare like with like.
Matrix products are plain ``torch`` matmuls, as the reference leaves them
to XLA outside any kernel.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.models.config import ModelConfig

# Sequences at or above this length take the reference's blocked
# (flash-style) attention, which a later slice of the port brings.
BLOCKED_ATTN_THRESHOLD = 2048

_NEG_INF = -1e30


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    x32 = x.to(torch.float32)
    var = torch.mean(torch.square(x32), dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * (1.0 + weight.to(torch.float32))).to(x.dtype)


def _rope_freqs(head_dim: int, theta: float, device) -> torch.Tensor:
    """Inverse frequencies, shape (head_dim // 2,)."""
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta**exponent)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Standard RoPE. x: (b, s, h, d); positions: (b, s) int."""
    freqs = _rope_freqs(x.shape[-1], theta, x.device)
    angles = positions[..., None].to(torch.float32) * freqs  # (b, s, d/2)
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def causal_mask_bias(seq: int, window: Optional[int], device) -> torch.Tensor:
    """(1, 1, seq, seq) additive float32 bias; window=None -> plain causal."""
    q_pos = torch.arange(seq, device=device)[:, None]
    k_pos = torch.arange(seq, device=device)[None, :]
    allowed = k_pos <= q_pos
    if window is not None:
        allowed &= k_pos > q_pos - window
    return torch.where(allowed, 0.0, _NEG_INF).to(torch.float32)[None, None]


def gqa_scores_softmax_value(
    q: torch.Tensor,  # (b, s_q, h, d)
    k: torch.Tensor,  # (b, s_k, kv, d)
    v: torch.Tensor,  # (b, s_k, kv, d)
    bias: Optional[torch.Tensor],  # broadcastable to (b, h, s_q, s_k) or None
) -> torch.Tensor:
    """Grouped-query attention core. Returns (b, s_q, h, d).

    The scores are computed and kept in float32 (the reference's
    ``preferred_element_type``); the probabilities are cast to v's dtype.
    """
    b, s_q, h, d = q.shape
    kv = k.shape[2]
    g = h // kv
    s_k = k.shape[1]
    qg = q.reshape(b, s_q, kv, g, d)
    # 1/sqrt(d) rounded in float32, as the reference computes it
    scale = float(np.float32(1.0) / np.sqrt(np.float32(d)))
    scores = torch.einsum("bqkgd,bskd->bkgqs", qg.to(torch.float32), k.to(torch.float32))
    scores = scores * scale
    if bias is not None:
        bias_ = torch.broadcast_to(bias, (b, h, s_q, s_k)).reshape(b, kv, g, s_q, s_k)
        scores = scores + bias_
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bkgqs,bskd->bqkgd", probs, v)
    return out.reshape(b, s_q, h, d)


def attention_train(
    cfg: ModelConfig,
    p: dict,
    x: torch.Tensor,  # (b, s, d_model)
    kind: int,  # 0 full/global, 1 local
    positions: torch.Tensor,  # (b, s)
) -> torch.Tensor:
    """Full-sequence causal attention for training."""
    b, s, _ = x.shape
    if s >= BLOCKED_ATTN_THRESHOLD:
        raise NotImplementedError(
            f"seq {s} >= {BLOCKED_ATTN_THRESHOLD} needs the blocked (flash) attention "
            "of repro.models.flash, which a later slice of the port brings"
        )
    if cfg.mrope_sections is not None:
        raise NotImplementedError("M-RoPE is not ported yet")
    hd = cfg.resolved_head_dim
    h, kvh = cfg.num_heads, cfg.num_kv_heads
    cd = x.dtype

    q = x @ p["wq"].to(cd)
    k = x @ p["wk"].to(cd)
    v = x @ p["wv"].to(cd)
    if cfg.qkv_bias:
        q = q + p["bq"].to(cd)
        k = k + p["bk"].to(cd)
        v = v + p["bv"].to(cd)
    q = apply_rope(q.reshape(b, s, h, hd), positions, cfg.rope_theta)
    k = apply_rope(k.reshape(b, s, kvh, hd), positions, cfg.rope_theta)
    v = v.reshape(b, s, kvh, hd)

    bias = causal_mask_bias(s, cfg.window_for_kind(kind), x.device)
    out = gqa_scores_softmax_value(q, k, v, bias)
    return out.reshape(b, s, h * hd) @ p["wo"].to(cd)


def swiglu_mlp(p: dict, x: torch.Tensor) -> torch.Tensor:
    cd = x.dtype
    gate = x @ p["w_gate"].to(cd)
    up = x @ p["w_up"].to(cd)
    act = torch.nn.functional.silu(gate.to(torch.float32)).to(cd) * up
    return act @ p["w_down"].to(cd)


def embed_tokens(embed: torch.Tensor, tokens: torch.Tensor, compute_dtype) -> torch.Tensor:
    return torch.nn.functional.embedding(tokens.long(), embed).to(compute_dtype)


def lm_head_logits(cfg: ModelConfig, params: dict, x: torch.Tensor) -> torch.Tensor:
    cd = x.dtype
    if cfg.tie_embeddings:
        return x @ params["embed"].to(cd).T
    return x @ params["lm_head"].to(cd)


def cross_entropy_loss(
    logits: torch.Tensor,  # (b, s, V)
    labels: torch.Tensor,  # (b, s) int
    mask: Optional[torch.Tensor] = None,  # (b, s) float/bool
) -> torch.Tensor:
    logits32 = logits.to(torch.float32)
    logz = torch.logsumexp(logits32, dim=-1)
    gold = torch.gather(logits32, -1, labels.long()[..., None])[..., 0]
    nll = logz - gold
    if mask is not None:
        mask = mask.to(torch.float32)
        return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)
    return torch.mean(nll)
