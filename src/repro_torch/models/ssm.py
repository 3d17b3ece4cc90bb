"""Mamba-2 (SSD) mixer of the ``ssm`` family, for training.

Counterpart of the training half of ``repro.models.ssm``: the same
de-fused z/x/B/C/dt projections and parameter names, so weights bridge key
for key. The reference's f32 islands are kept: the causal conv, silu,
softplus, A = −exp(A_log) and the gated norm run in float32 and cast back
to the compute dtype. Prefill and decode come with the generate path.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models.config import ModelConfig

f32 = torch.float32


def rms_norm_gated(y: torch.Tensor, z: torch.Tensor, weight: torch.Tensor,
                   eps: float) -> torch.Tensor:
    """Mamba-2 gated RMSNorm: norm(y * silu(z)) * (1 + w)."""
    y32 = y.to(f32) * F.silu(z.to(f32))
    var = torch.mean(torch.square(y32), dim=-1, keepdim=True)
    out = y32 * torch.rsqrt(var + eps) * (1.0 + weight.to(f32))
    return out.to(y.dtype)


def causal_depthwise_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """x: (batch, seq, ch); w: (K, ch); b: (ch,). Causal depthwise conv1d in
    float32: out[t] = Σ_k w[k]·x[t−K+1+k] + b, written as K shifted
    multiply-adds (the reference's ``lax.conv_general_dilated``), so its
    backward is plain elementwise work with no algorithm choice to vary."""
    K = w.shape[0]
    s = x.shape[1]
    xp = F.pad(x.to(f32), (0, 0, K - 1, 0))
    w32 = w.to(f32)
    out = xp[:, 0:s] * w32[0]
    for k in range(1, K):
        out = out + xp[:, k:k + s] * w32[k]
    return (out + b.to(f32)).to(x.dtype)


def _project(p: Dict, x: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """Common z/x/B/C/dt projection. x: (b, s, d)."""
    cd = x.dtype
    return tuple(x @ p[k].to(cd) for k in ("in_z", "in_x", "in_B", "in_C", "in_dt"))


def ssm_mixer_train(cfg: ModelConfig, p: Dict, x: torch.Tensor) -> torch.Tensor:
    """Full-sequence SSD mixer. x: (b, s, d_model) -> (b, s, d_model)."""
    b, s, _ = x.shape
    nh, ph = cfg.ssm_heads, cfg.ssm_headdim
    cd = x.dtype

    z, xs, B, C, dt_raw = _project(p, x)
    xs = F.silu(causal_depthwise_conv(xs, p["conv_x"], p["conv_bx"]).to(f32)).to(cd)
    B = F.silu(causal_depthwise_conv(B, p["conv_B"], p["conv_bB"]).to(f32)).to(cd)
    C = F.silu(causal_depthwise_conv(C, p["conv_C"], p["conv_bC"]).to(f32)).to(cd)

    dt = F.softplus(dt_raw.to(f32) + p["dt_bias"].to(f32))
    A = -torch.exp(p["A_log"].to(f32))  # (nh,)

    xh = xs.reshape(b, s, nh, ph)
    y, _ = ops.ssd_scan(xh, dt, A, B, C, cfg.ssm_chunk)
    y = y + p["D"].to(cd)[None, None, :, None] * xh
    y = rms_norm_gated(y.reshape(b, s, cfg.d_inner), z, p["gate_norm"], cfg.norm_eps)
    return y @ p["out_proj"].to(cd)


def ssm_param_shapes(cfg: ModelConfig) -> Dict:
    """Shapes for one layer (callers stack a leading L dim)."""
    d, di, n, nh, K = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_conv
    return {
        "in_z": (d, di),
        "in_x": (d, di),
        "in_B": (d, n),
        "in_C": (d, n),
        "in_dt": (d, nh),
        "conv_x": (K, di),
        "conv_bx": (di,),
        "conv_B": (K, n),
        "conv_bB": (n,),
        "conv_C": (K, n),
        "conv_bC": (n,),
        "dt_bias": (nh,),
        "A_log": (nh,),
        "D": (nh,),
        "gate_norm": (di,),
        "out_proj": (di, d),
    }
